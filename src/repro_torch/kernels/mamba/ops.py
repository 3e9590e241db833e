"""Public Mamba selective-scan entry point with device dispatch, and the
single-token decode step.

A CPU tensor goes to the plain PyTorch version (``ref``).  A CUDA tensor goes
to the hand-written Hopper kernel (``csrc/selective_scan.cu``), or to ``ref``
only when ``impl="ref"`` is passed explicitly.  Nothing falls back: a CUDA
input the kernel does not take raises.

``selective_step`` is the plain counterpart of ``selective_step_xla``; the
JAX package has no Pallas kernel for it, so it stays plain torch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, grad_required
from repro_torch.kernels.mamba.ref import selective_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16          # the kernel keeps n <= 16 states per thread


def variant(n: int) -> str:
    """The kernel instantiation that takes state size ``n``: "np<NP>", n
    padded to NP = 4, 8 or 16 states."""
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n}; the kernel takes 1..{MAX_STATE}")
    return f"np{4 if n <= 4 else 8 if n <= 8 else 16}"


def selective_scan(x, dt, A, Bm, C, D, h0, *, impl: Optional[str] = None):
    """x, dt: (B, T, d); A: (d, n); Bm, C: (B, T, n); D: (d,); h0: (B, d, n).

    Returns (y (B, T, d) in x's dtype, h_last (B, d, n)).  ``impl``: None
    (the tensor's device decides) or "ref".
    """
    if impl not in (None, "ref"):
        raise ValueError(f"unknown selective-scan impl {impl!r}")
    if impl == "ref" or x.device.type == "cpu":
        return selective_scan_ref(x, dt, A, Bm, C, D, h0)
    if grad_required(x, dt, A, Bm, C, D, h0):
        raise NotImplementedError(
            "selective_scan has no backward kernel yet (ROADMAP B4): training "
            "through it on CUDA waits for it; impl='ref' differentiates")
    return selective_scan_cuda(x, dt, A, Bm, C, D, h0)


def selective_step(x, dt, A, Bm, C, D, h0):
    """Single-token decode step.  x, dt: (B, d); Bm, C: (B, n).

    Returns (y (B, d) in x's dtype, h (B, d, n) in h0's dtype)."""
    xf, dtf = x.float(), dt.float()
    da = torch.exp(dtf[..., None] * A.float()[None])
    db = (dtf * xf)[..., None] * Bm.float()[:, None, :]
    h = da * h0.float() + db
    y = (h @ C.float()[..., None])[..., 0] + D.float()[None] * xf
    return y.to(x.dtype), h.to(h0.dtype)


def check_inputs(x, dt, A, Bm, C, D, h0) -> None:
    """Raise on what the kernel does not take (device aside).

    x and dt must be contiguous; Bm and C may be column slices of a wider
    tensor (the kernel takes their batch and time strides) but each row's
    n values must be adjacent."""
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be one (B, T, d) shape: "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    B, T, d = x.shape
    if A.dim() != 2 or A.shape[0] != d:
        raise ValueError(f"A must be (d, n) with d = {d}: {tuple(A.shape)}")
    n = A.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n}; the kernel takes 1..{MAX_STATE}")
    for name, t in (("Bm", Bm), ("C", C)):
        if t.shape != (B, T, n):
            raise ValueError(f"{name} must be (B, T, n) = {(B, T, n)}, got "
                             f"{tuple(t.shape)}")
        if t.stride(2) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if D.shape != (d,) or h0.shape != (B, d, n):
        raise ValueError(f"D must be ({d},) and h0 {(B, d, n)}: "
                         f"{tuple(D.shape)}, {tuple(h0.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if Bm.dtype not in _DTYPES or C.dtype != Bm.dtype:
        raise ValueError(f"Bm and C must share a dtype, float32 or bfloat16: "
                         f"{Bm.dtype}, {C.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D), ("h0", h0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("D", D), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid limit")


def selective_scan_cuda(x, dt, A, Bm, C, D, h0):
    """Launch the Hopper kernel on ``torch.cuda.current_stream()``."""
    args = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("C", C), ("D", D),
            ("h0", h0))
    for name, t in args:
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs CUDA")
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")
    check_inputs(x, dt, A, Bm, C, D, h0)
    B, T, d = x.shape
    n = A.shape[1]
    y = torch.empty_like(x)
    if B * d == 0 or T == 0:
        return y, h0.clone()
    h_last = torch.empty_like(h0)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.selective_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), _DTYPES[x.dtype], _DTYPES[Bm.dtype], B, T, d,
            n, Bm.stride(0), Bm.stride(1), C.stride(0), C.stride(1), stream)
    if err:
        msg = lib.selective_scan_error_string(err).decode()
        raise RuntimeError(f"selective_scan launch failed: {msg} ({err})")
    LAUNCHES["selective_scan"] += 1
    return y, h_last


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("selective_scan")
    fn = lib.selective_scan
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 9 + [i32] * 6 + [i64] * 4 + [ptr]
        fn.restype = i32
        lib.selective_scan_error_string.argtypes = [i32]
        lib.selective_scan_error_string.restype = ctypes.c_char_p
    return lib
