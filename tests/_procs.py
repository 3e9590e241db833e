"""Subprocesses that a test module starts at once and its tests wait on.

``Started`` is one group of processes (one command, or the ranks of one
process group) under one limit counted from its start.  A module starts
each of its groups in a module fixture, and each test waits only on the
group whose output it reads: a group that fails or runs past its limit
fails only those tests.  Each process writes its output to files beside
its results, so that no pipe fills while nothing reads it.
"""
import json
import os
import subprocess
import time

import pytest


class Started:
    def __init__(self, name, cmds, logs, limit, *, cwd, env):
        self.name, self.limit = name, limit
        self.logs = logs
        self.procs = []
        for cmd, log in zip(cmds, logs):
            with open(f"{log}.out", "w") as out, \
                    open(f"{log}.err", "w") as err:
                self.procs.append(subprocess.Popen(
                    cmd, cwd=cwd, env=env, stdout=out, stderr=err,
                    text=True))
        self.deadline = time.monotonic() + limit
        self.error = None

    def wait(self):
        """Waits for every process, up to the limit; fails the calling test
        if one ran past it or exited with an error (and every later test
        that waits on this group)."""
        if self.error is None and any(p.returncode is None
                                      for p in self.procs):
            try:
                for p in self.procs:
                    p.wait(timeout=max(0.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.stop()
                self.error = f"ran past its limit of {self.limit} s"
            else:
                bad = [i for i, p in enumerate(self.procs) if p.returncode]
                if bad:
                    i = bad[0]
                    self.error = (f"process {i} exited with "
                                  f"{self.procs[i].returncode}:\n"
                                  + self.tail(i))
        if self.error is not None:
            pytest.fail(f"{self.name}: {self.error}")

    def stdout(self, i=0) -> str:
        with open(f"{self.logs[i]}.out") as f:
            return f.read()

    def tail(self, i, n=3000) -> str:
        with open(f"{self.logs[i]}.err") as f:
            return self.stdout(i)[-n:] + f.read()[-n:]

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def rank_outputs(started):
    """Each rank's readings (``out{r}.json`` beside its log), once every
    rank has ended."""
    started.wait()
    return [json.loads((log.parent / f"out{r}.json").read_text())
            for r, log in enumerate(started.logs)]


def child_env(root):
    """The test process's environment for a child that imports the port
    and the test helpers, on one intra-op thread, outside pytest's and
    any process group's variables."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "MASTER_", "RANK", "WORLD_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src"), str(root / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    return env
