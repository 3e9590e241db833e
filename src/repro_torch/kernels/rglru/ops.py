"""Public RG-LRU linear-scan entry point with device dispatch.

A CPU tensor goes to the plain PyTorch version (``ref``).  A CUDA tensor goes
to the hand-written Hopper kernel (``csrc/linear_scan.cu``), or to ``ref``
only when ``impl="ref"`` is passed explicitly.  Nothing falls back: a CUDA
input the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import count_launch, grad_required
from repro_torch.kernels.rglru.ref import linear_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def linear_scan(x, a, h0, *, impl: Optional[str] = None):
    """h_t = a_t * h_{t-1} + x_t over axis 1.  x, a: (B, T, C); h0: (B, C).

    Returns (y (B, T, C) in x's dtype, h_last (B, C)).  ``impl``: None (the
    tensor's device decides) or "ref".
    """
    if impl not in (None, "ref"):
        raise ValueError(f"unknown linear-scan impl {impl!r}")
    if impl == "ref" or x.device.type == "cpu":
        return linear_scan_ref(x, a, h0)
    if grad_required(x, a, h0):
        raise NotImplementedError(
            "linear_scan has no backward kernel yet (ROADMAP B3): training "
            "through it on CUDA waits for it; impl='ref' differentiates")
    return linear_scan_cuda(x, a, h0)


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
    for name, t in (("x", x), ("a", a), ("h0", h0)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs CUDA")
    if a.device != x.device or h0.device != x.device:
        raise ValueError("x, a, h0 must be on one device")
    check_inputs(x, a, h0)
    B, T, C = x.shape
    y = torch.empty_like(x)
    if B * C == 0 or T == 0:
        return y, h0.clone()
    h_last = torch.empty_like(h0)
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


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("linear_scan")
    fn = lib.linear_scan
    if fn.argtypes is None:   # typed last: a thread that sees it sees all
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = i32
        lib.linear_scan_error_string.argtypes = [i32]
        lib.linear_scan_error_string.restype = ctypes.c_char_p
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    return lib
