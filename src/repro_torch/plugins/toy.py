"""The paper's validation workload (§4.3): mkfile + ccount kernels."""
from __future__ import annotations

import os
import tempfile

import numpy as np

from repro_torch.core.kernel_plugin import register_kernel


@register_kernel("misc.mkfile",
                 description="create a buffer/file of random characters")
def mkfile(args, ctx):
    n = int(args.get("bytes", 1 << 20))
    seed = int(args.get("seed", 0))
    rng = np.random.default_rng(seed)
    data = rng.integers(97, 123, n, dtype=np.uint8)  # a..z
    path = args.get("path")
    if args.get("to_disk", False):
        fd, path = tempfile.mkstemp(prefix="enmd_mkfile_")
        with os.fdopen(fd, "wb") as f:
            f.write(data.tobytes())
        return {"path": path, "bytes": n}
    return {"data": data, "bytes": n}


@register_kernel("misc.ccount",
                 description="character count over a mkfile output")
def ccount(args, ctx):
    src = args.get("input")
    if src is None:
        deps = ctx.get("dep_results") or {}
        src = next(iter(deps.values()), None)
    if src is None:
        staged = ctx.get("staged_inputs") or []
        src = staged[0] if staged else None
    if isinstance(src, dict) and "data" in src:
        data = src["data"]
    elif isinstance(src, dict) and "path" in src:
        data = np.fromfile(src["path"], dtype=np.uint8)
    elif isinstance(src, str):
        data = np.fromfile(src, dtype=np.uint8)
    else:
        raise ValueError("ccount: no input")
    counts = np.bincount(data, minlength=256)
    return {"total": int(counts.sum()),
            "distinct": int((counts > 0).sum()),
            "top": int(np.argmax(counts))}
