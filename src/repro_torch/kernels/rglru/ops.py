"""Public RG-LRU linear-scan entry point with device dispatch, and its
gradient.

A CPU tensor goes to the plain PyTorch version (``ref``).  A CUDA tensor goes
to the hand-written Hopper kernel (``csrc/linear_scan.cu``), or to ``ref``
only when ``impl="ref"`` is passed explicitly.  Nothing falls back: a CUDA
input the kernel does not take raises.

When autograd records the call (or the inputs come wrapped by
``torch.func.vmap``) ``linear_scan`` runs through ``LinearScan``, an
``autograd.Function`` whose backward is the reverse-scan kernel
(``csrc/linear_scan_bwd.cu``; ``linear_scan_bwd_ref`` on the CPU or with
``impl="ref"``).  ``LAUNCHES["linear_scan_bwd"]`` counts its launches.  Its
``vmap`` rule folds the member axis into the batch (the scan has no
weights): one launch for all members.

``cost`` and ``bwd_cost`` give each kernel's (FLOPs, bytes); on fake
tensors the launchers make their outputs and workspaces, count the call in
``FAKE_CALLS`` with its cost, and return before the library
(``kernels.is_fake``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import (
    check_device,
    count_fake,
    count_launch,
    fold_members,
    grad_required,
    is_fake,
    transformed,
    unfold_members,
)
from repro_torch.kernels.rglru.ref import linear_scan_bwd_ref, linear_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cost(B: int, T: int, C: int, itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one forward call: a multiply and an add a step and
    channel; x, a read and y written in x's dtype, h0 read and h_last
    written in f32."""
    return float(2 * B * T * C), float(3 * B * T * C * itemsize
                                       + 2 * B * C * 4)


def bwd_cost(B: int, T: int, C: int, itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one backward call: 3 flops a step and channel (5
    for bf16 inputs, whose f32 states are recomputed); a, dy and h_{t-1}
    (y, or x to recompute it) read and dx, da written in x's dtype, h0 and
    dh_last read and dh0 written in f32."""
    flops = (3 if itemsize == 4 else 5) * B * T * C
    return float(flops), float(5 * B * T * C * itemsize + 3 * B * C * 4)


def linear_scan(x, a, h0, *, impl: Optional[str] = None):
    """h_t = a_t * h_{t-1} + x_t over axis 1.  x, a: (B, T, C); h0: (B, C).

    Returns (y (B, T, C) in x's dtype, h_last (B, C)).  ``impl``: None (the
    tensor's device decides) or "ref".
    """
    if impl not in (None, "ref"):
        raise ValueError(f"unknown linear-scan impl {impl!r}")
    plain = impl == "ref" or x.device.type == "cpu"
    if grad_required(x, a, h0) or transformed(x, a, h0):
        return LinearScan.apply(x, a, h0, plain)
    if plain:
        return linear_scan_ref(x, a, h0)
    return linear_scan_cuda(x, a, h0)


class LinearScan(torch.autograd.Function):
    """(y, h_last) = linear_scan(x, a, h0); saves x, a, h0 and y.  The
    backward kernel reads h_{t-1} from y for float32 inputs and recomputes
    the states in float32 for bfloat16 ones.  ``plain``: the plain
    versions instead of the kernels."""

    @staticmethod
    def forward(x, a, h0, plain):
        if plain:
            return linear_scan_ref(x, a, h0)
        return linear_scan_cuda(x, a, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, a, h0, plain = inputs
        ctx.save_for_backward(x, a, h0, output[0])
        ctx.plain = plain

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, a, h0, y = ctx.saved_tensors
        if ctx.plain:
            dx, da, dh0 = linear_scan_bwd_ref(x, a, h0, dy, dh_last)
        else:
            dx, da, dh0 = linear_scan_bwd_cuda(x, a, h0, y, dy.contiguous(),
                                               dh_last.contiguous())
        return dx, da, dh0, None

    @staticmethod
    def vmap(info, in_dims, x, a, h0, plain):
        """Fold the member axis into the batch: one launch for all."""
        n = info.batch_size
        y, h = LinearScan.apply(*(fold_members(t, d, n) for t, d in
                                  zip((x, a, h0), in_dims[:3])), plain)
        return (unfold_members(y, n), unfold_members(h, n)), (0, 0)


def check_inputs(x, a, h0) -> None:
    """Raise on what the kernel does not take (device aside)."""
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"x and a must be one (B, T, C) shape: "
                         f"{tuple(x.shape)}, {tuple(a.shape)}")
    B, _, C = x.shape
    if h0.shape != (B, C):
        raise ValueError(f"h0 must be (B, C) = {(B, C)}, got "
                         f"{tuple(h0.shape)}")
    if x.dtype not in _DTYPES or a.dtype != x.dtype:
        raise ValueError(f"x and a must share a dtype, float32 or bfloat16: "
                         f"{x.dtype}, {a.dtype}")
    if h0.dtype != torch.float32:
        raise ValueError(f"h0 must be float32, got {h0.dtype}")
    for name, t in (("x", x), ("a", a), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def linear_scan_cuda(x, a, h0):
    """Launch the Hopper kernel on ``torch.cuda.current_stream()``."""
    fake = is_fake(x, a, h0)
    check_device(fake, x=x, a=a, h0=h0)
    check_inputs(x, a, h0)
    B, T, C = x.shape
    y = torch.empty_like(x)
    if B * C == 0 or T == 0:
        return y, h0.clone()
    h_last = torch.empty_like(h0)
    if fake:
        count_fake(cost(B, T, C, x.element_size()), "linear_scan")
        return y, h_last
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.linear_scan(x.data_ptr(), a.data_ptr(), h0.data_ptr(),
                              y.data_ptr(), h_last.data_ptr(), _DTYPES[x.dtype],
                              B, T, C, stream)
    if err:
        msg = lib.linear_scan_error_string(err).decode()
        raise RuntimeError(f"linear_scan launch failed: {msg} ({err})")
    count_launch("linear_scan")
    return y, h_last


def linear_scan_bwd_cuda(x, a, h0, y, dy, dh_last):
    """Launch the reverse-scan kernel on ``torch.cuda.current_stream()``:
    (dx, da, dh0) from the forward's inputs, its output y and the output
    gradients dy (x's dtype) and dh_last (float32)."""
    fake = is_fake(x, a, h0, y, dy, dh_last)
    check_device(fake, x=x, a=a, h0=h0, y=y, dy=dy, dh_last=dh_last)
    check_inputs(x, a, h0)
    for name, t, dtype in (("y", y, x.dtype), ("dy", dy, x.dtype),
                           ("dh_last", dh_last, torch.float32)):
        want = h0.shape if name == "dh_last" else x.shape
        if t.shape != want or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {tuple(want)} "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")
    B, T, C = x.shape
    dx, da = torch.empty_like(x), torch.empty_like(a)
    if B * C == 0 or T == 0:
        return dx, da, dh_last.clone()
    dh0 = torch.empty_like(h0)
    # bf16 outputs are rounded: the kernel's first pass writes the f32
    # states here, and the reverse pass reads h_{t-1} from them
    hs = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
          if x.dtype != torch.float32 else None)
    if fake:
        count_fake(bwd_cost(B, T, C, x.element_size()), "linear_scan_bwd")
        return dx, da, dh0
    lib = _library("linear_scan_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.linear_scan_bwd(
            x.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
            dy.data_ptr(), dh_last.data_ptr(),
            None if hs is None else hs.data_ptr(), dx.data_ptr(),
            da.data_ptr(), dh0.data_ptr(), _DTYPES[x.dtype], B, T, C, stream)
    if err:
        msg = lib.linear_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"linear_scan_bwd launch failed: {msg} ({err})")
    count_launch("linear_scan_bwd")
    return dx, da, dh0


_ARGTYPES = {   # library: its launch entry's pointer and int arguments
    "linear_scan": (5, 4),         # x a h0 y h_last; dtype B T C
    "linear_scan_bwd": (10, 4),    # x a h0 y dy dh_last hs dx da dh0; ...
}


def _library(name: str = "linear_scan"):
    """The loaded library ``name`` (linear_scan or linear_scan_bwd), its C
    entries typed."""
    from repro_torch.kernels import _build
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:   # typed last: a thread that sees it sees all
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        fn.restype = i32
        n_ptr, n_int = _ARGTYPES[name]
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
    return lib
