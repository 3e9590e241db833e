"""Op-level cost model for the one-device dry run and roofline (the port's
counterpart of ``repro.roofline.hlo_costs``, which parses a compiled XLA
module's HLO text).

The port has no HLO: ``OpCounter`` is a ``TorchDispatchMode`` that counts
every aten op of a traced step as it runs (on fake tensors, nothing is
computed).  Eager tracing sees every layer and microbatch, so there are no
``while`` trip counts to recover.  As in ``hlo_costs``:

  * FLOPs are matmul-family work only (the tensor cores' share, XLA's
    dot and convolution): mm, addmm, bmm, baddbmm, addbmm, mv, dot, ...
    at 2 * M * N * K, convolutions at 2 * output elements * kernel
    elements * input channels a group;
  * bytes are operand plus result bytes of every op that moves data, 0
    for views and aliases and for allocations that write nothing
    (``empty``, ``empty_like``, ``empty_strided``);
  * the hand kernels, which run outside the dispatcher, add their own
    ``cost()`` (FLOPs and bytes) through ``kernels.cost_sink``, per kernel
    in ``OpCounter.kernels``;
  * collectives: none on one device (the fields stay for the report).
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import cost_sink

aten = torch.ops.aten


@dataclass
class Costs:
    flops: float = 0.0               # matmul-family FLOPs (tensor-core work)
    bytes_accessed: float = 0.0      # operand+result bytes of data-moving ops
    collectives: Dict[str, Dict[str, float]] = field(
        default_factory=lambda: defaultdict(
            lambda: {"count": 0.0, "result_bytes": 0.0, "wire_bytes": 0.0}))

    @property
    def collective_wire_bytes(self) -> float:
        return sum(v["wire_bytes"] for v in self.collectives.values())


def _numel(t) -> int:
    return math.prod(t.shape)


def _mm_flops(func, args) -> float:
    """2 * M * N * K of a matmul-family op, from its operands' shapes."""
    if func in (aten.mm.default, aten.bmm.default):
        a, b = args[0], args[1]
    elif func in (aten.addmm.default, aten.baddbmm.default,
                  aten.addbmm.default, aten.addmv.default):
        a, b = args[1], args[2]
    elif func in (aten.mv.default, aten.dot.default, aten.vdot.default):
        a, b = args[0], args[1]
    else:
        return 0.0
    k = a.shape[-1]
    batch = a.shape[0] if a.dim() == 3 else 1
    m = a.shape[-2] if a.dim() >= 2 else 1
    n = b.shape[-1] if b.dim() >= 2 else 1
    return 2.0 * batch * m * n * k


def _conv_flops(args, out) -> float:
    w = args[1]
    groups = args[8] if len(args) > 8 else 1
    in_per_group = w.shape[1] if not args[6] else w.shape[0] // groups
    return 2.0 * _numel(out) * math.prod(w.shape[2:]) * in_per_group


_MATMUL = {aten.mm.default, aten.addmm.default, aten.bmm.default,
           aten.baddbmm.default, aten.addbmm.default, aten.mv.default,
           aten.addmv.default, aten.dot.default, aten.vdot.default}
_CONV = {aten.convolution.default}
_NO_DATA = {aten.empty.memory_format, aten.empty_like.default,
            aten.empty_strided.default, aten.new_empty.default,
            aten.new_empty_strided.default, aten.detach.default,
            aten.lift_fresh.default, aten.alias.default}


def _tensor_bytes(tree) -> int:
    return sum(_numel(t) * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every op run while it is active, and the
    hand kernels' costs (``kernels``: name -> {"calls", "flops",
    "bytes"}); ``costs`` holds the totals."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.kernels: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
        self._sink = None

    def _kernel(self, name: str, flops: float, nbytes: float,
                launch: dict) -> None:
        k = self.kernels[name]
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.costs.flops += flops
        self.costs.bytes_accessed += nbytes

    def __enter__(self):
        self._sink = cost_sink(self._kernel)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._sink.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _MATMUL:
            self.costs.flops += _mm_flops(func, args)
        elif func in _CONV:
            self.costs.flops += _conv_flops(args, out)
        if not (func.is_view or func in _NO_DATA):
            self.costs.bytes_accessed += (_tensor_bytes((args, kwargs))
                                          + _tensor_bytes(out))
        return out
