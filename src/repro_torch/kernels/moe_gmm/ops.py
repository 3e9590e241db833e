"""Public MoE grouped-matmul entry point with device dispatch.

A CPU tensor goes to the plain PyTorch version (``ref``).  A CUDA tensor goes
to the hand-written Hopper kernels (``csrc/gmm.cu``), or to ``ref`` only when
``impl="ref"`` is passed explicitly.  Nothing falls back: a CUDA input the
kernels do not take raises.  Both follow ``repro.kernels.moe_gmm.ref``
(padding rows exactly 0), not the JAX package's ``xla`` branch, which
computes them.

Which kernel a launch takes is fixed by ``variant`` (the C launcher applies
the same rule): bf16 with C > 16, D > 0, D % 8 == F % 8 == 0, 16-byte
aligned x, w and out (TMA's stride and address rule), at most
``MAX_WGMMA_EXPERTS`` experts and C * F < 2^34 runs the wgmma/TMA kernel
(prefill); other bf16 inputs, decode's C <= 16 among them, the mma.sync
kernel; f32 the CUDA-core kernel.  ``LAUNCHES["gmm"]`` counts every launch,
``LAUNCHES["gmm.<variant>"]`` each variant's.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import count_launch, grad_required, transformed
from repro_torch.kernels.moe_gmm.ref import gmm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WGMMA_EXPERTS = 1024   # the wgmma kernel stages the sizes on chip
VARIANTS = ("f32", "mma_sync", "wgmma")   # the C library's numbering


def variant(dtype: torch.dtype, E: int, C: int, D: int, F: int,
            aligned: bool = True) -> str:
    """The kernel that takes a launch; ``aligned``: x, w and out start on a
    16-byte boundary."""
    if dtype == torch.float32:
        return "f32"
    if (C > 16 and D > 0 and D % 8 == 0 and F % 8 == 0 and aligned
            and E <= MAX_WGMMA_EXPERTS and C * F < 2 ** 34):
        return "wgmma"
    return "mma_sync"


def gmm(x, w, group_sizes, *, impl: Optional[str] = None):
    """x: (E, C, D); w: (E, D, F); group_sizes: (E,) int32.  Returns
    (E, C, F) in x's dtype, rows past ``group_sizes[e]`` exactly 0.

    ``impl``: None (the tensor's device decides) or "ref".
    """
    if impl not in (None, "ref"):
        raise ValueError(f"unknown moe impl {impl!r}")
    if impl == "ref" or x.device.type == "cpu":
        return gmm_ref(x, w, group_sizes)
    if grad_required(x, w) or transformed(x, w, group_sizes):
        raise NotImplementedError(
            "gmm has no backward kernel and no vmap rule yet (ROADMAP B2): "
            "training through it on CUDA, or vmapping it, waits for them; "
            "impl='ref' differentiates")
    return gmm_cuda(x, w, group_sizes)


def check_inputs(x, w, group_sizes) -> None:
    """Raise on what the kernel does not take (device aside)."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be (E, C, D) and w (E, D, F): "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    E, _, D = x.shape
    if w.shape[0] != E or w.shape[1] != D:
        raise ValueError(f"w must be (E, D, F) = ({E}, {D}, F), got "
                         f"{tuple(w.shape)}")
    if group_sizes.shape != (E,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be ({E},) int32, got "
                         f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x and w must share a dtype, float32 or bfloat16: "
                         f"{x.dtype}, {w.dtype}")
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if E > 65535:
        raise ValueError(f"{E} experts exceed the grid limit of 65535")


def gmm_cuda(x, w, group_sizes):
    """Launch the Hopper kernel on ``torch.cuda.current_stream()``.  The
    sizes stay on the device: the kernel reads them there."""
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs CUDA")
    if w.device != x.device or group_sizes.device != x.device:
        raise ValueError("x, w, group_sizes must be on one device")
    check_inputs(x, w, group_sizes)
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, out))
    vec = int(D % 8 == 0 and F % 8 == 0 and aligned)
    kind = variant(x.dtype, E, C, D, F, aligned)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gmm(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                      out.data_ptr(), _DTYPES[x.dtype], E, C, D, F, vec,
                      stream)
    if err:
        msg = lib.gmm_error_string(err).decode()
        raise RuntimeError(f"gmm launch failed: {msg} ({err})")
    count_launch("gmm", f"gmm.{kind}")
    return out


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("gmm")
    fn = lib.gmm
    if fn.argtypes is None:   # typed last: a thread that sees it sees all
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = i32
        lib.gmm_error_string.argtypes = [i32]
        lib.gmm_error_string.restype = ctypes.c_char_p
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    return lib


def kernel_variant(dtype: torch.dtype, E: int, C: int, D: int, F: int,
                   aligned: bool = True) -> str:
    """The variant the built library's launcher picks (needs nvcc)."""
    fn = _library().gmm_variant
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    vec = int(D % 8 == 0 and F % 8 == 0 and aligned)
    code = fn(_DTYPES[dtype], E, C, D, F, vec)
    if code < 0:
        raise ValueError(f"no gmm kernel takes {dtype}")
    return VARIANTS[code]


def kernel_smem_bytes() -> int:
    """Dynamic shared memory per block of the wgmma kernel, as the built
    library states it (needs nvcc)."""
    fn = _library().gmm_wgmma_smem_bytes
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()
