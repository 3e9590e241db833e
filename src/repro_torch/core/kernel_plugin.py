"""Kernel plugins: the paper's task abstraction (own copy of
``repro.core.kernel_plugin``, registering the port's task kernels).

A kernel plugin names a computational tool + its environment and data
movement, independent of the pattern it runs in.  Plugins register under
dotted names ("lm.decode", ...).

Interface (paper listing 2):
    k = Kernel(name="lm.decode")
    k.arguments = {"arch": "gemma2-2b", "device": "cuda"}
    k.execute()
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

_KERNEL_REGISTRY: Dict[str, "KernelDef"] = {}


class KernelDef:
    def __init__(self, name: str, fn: Callable[..., Any], *,
                 idempotent: bool = True, description: str = ""):
        self.name = name
        self.fn = fn
        self.idempotent = idempotent
        self.description = description


def register_kernel(name: str, *, idempotent: bool = True,
                    description: str = ""):
    def deco(fn):
        if name in _KERNEL_REGISTRY:
            raise ValueError(f"kernel {name} already registered")
        _KERNEL_REGISTRY[name] = KernelDef(name, fn, idempotent=idempotent,
                                           description=description)
        return fn
    return deco


def kernel_names() -> List[str]:
    _ensure_plugins()
    return sorted(_KERNEL_REGISTRY)


def _ensure_plugins():
    import repro_torch.plugins  # noqa: F401  (registers the port's plugins)


class Kernel:
    """A bound instance of a kernel plugin (one per task)."""

    def __init__(self, name: str):
        _ensure_plugins()
        if name not in _KERNEL_REGISTRY:
            raise KeyError(f"unknown kernel plugin {name!r}; "
                           f"available: {kernel_names()}")
        self._def = _KERNEL_REGISTRY[name]
        self.name = name
        self.arguments: Dict[str, Any] = {}
        self.upload_input_data: List[Any] = []
        self.download_output_data: List[Any] = []
        self.timings = {"data_in": 0.0, "data_out": 0.0, "exec": 0.0}

    def execute(self, ctx: Optional[Dict[str, Any]] = None) -> Any:
        """Run the kernel: stage data in, execute, stage data out.  When a
        staging layer manages the run (``ctx["staging_managed"]``) the
        upload/download phases are skipped here."""
        ctx = dict(ctx or {})
        managed = bool(ctx.get("staging_managed"))
        t0 = time.perf_counter()
        if not managed:
            staged = [u() if callable(u) else u
                      for u in self.upload_input_data]
            ctx.setdefault("staged_inputs", staged)
        self.timings["data_in"] = time.perf_counter() - t0

        t1 = time.perf_counter()
        result = self._def.fn(self.arguments, ctx)
        self.timings["exec"] = time.perf_counter() - t1

        t2 = time.perf_counter()
        if not managed:
            for d in self.download_output_data:
                if callable(d):
                    d(result)
        self.timings["data_out"] = time.perf_counter() - t2
        return result

    @property
    def idempotent(self) -> bool:
        return self._def.idempotent
