"""The paper's own validation workload (Section 4.3): mkfile + ccount.

A two-stage toy application: stage 1 creates a buffer of random characters
(``misc.mkfile``), stage 2 counts characters (``misc.ccount``).  Used by the
Fig.5 pattern-characterization benchmark with all three execution patterns.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ToyWorkloadConfig:
    name: str = "charcount"
    file_bytes: int = 1 << 20      # per-task buffer size (paper: ~MB files)
    stages: int = 2
    # Fig.5 sweep: tasks = cores, 24..192
    task_sweep: tuple = (24, 48, 96, 192)


CONFIG = ToyWorkloadConfig()
