"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
into its own shared library under ``kernels/_build/`` (listed in
``.gitignore``).  A library's file name carries a hash of its source, the
headers it includes (``common/hopper.cuh``) and the compiler flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it
is.  ``build`` starts one ``nvcc`` per missing library, all at once, and
waits for them together.  ``build`` and ``load`` hold one lock, so threads
of one process (the pilot's task threads) that need a library at once
build it once and share one handle; each build writes a temporary file
named for its process and thread before it takes the library's name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR / "_build"

# kernel library name -> its source, relative to this package
SOURCES: Dict[str, str] = {
    "flash_attention_fwd": "flash_attention/csrc/flash_attention_fwd.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "linear_scan": "rglru/csrc/linear_scan.cu",
    "linear_scan_bwd": "rglru/csrc/linear_scan_bwd.cu",
    "selective_scan": "mamba/csrc/selective_scan.cu",
    "selective_scan_bwd": "mamba/csrc/selective_scan_bwd.cu",
    "gmm": "moe_gmm/csrc/gmm.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()   # build and load, and _LOADED


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels (looked on PATH and in /usr/local/cuda)")


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(src: Path) -> List[Path]:
    """``src`` and every header it includes with ``#include "..."``,
    directly or through another header, resolved against the including
    file's directory; headers that do not exist there (the toolkit's) are
    left out."""
    files, todo = [], [src.resolve()]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            dep = (path.parent / inc).resolve()
            if dep.is_file():
                todo.append(dep)
    return files


def source_digest(src: Path) -> str:
    """Hash of ``src``, the headers it includes and the compiler flags."""
    h = hashlib.sha256()
    for path in source_files(src):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def library_path(name: str) -> Path:
    digest = source_digest(_KERNELS_DIR / SOURCES[name])
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named library that is missing, in parallel.

    Returns ``{name: {"seconds", "cached", "ptxas"}}``; ``ptxas`` holds the
    compiler's register and shared-memory report.  Raises on a failed build.
    """
    with _LOCK:
        return _build_missing(list(SOURCES if names is None else names))


def _build_missing(names: List[str]) -> Dict[str, dict]:
    info: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            info[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(_KERNELS_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        info[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                      "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib
