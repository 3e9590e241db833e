"""Public MoE grouped-matmul entry point with device dispatch, and its
gradient.

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

When autograd records the call (or the inputs come wrapped by
``torch.func.vmap``) ``gmm`` runs through ``GroupedMatmul``, an
``autograd.Function`` whose backward is the pair of kernels in
``csrc/gmm_bwd.cu`` (dx = mask(dy) w^T and dw = x^T mask(dy);
``gmm_bwd_ref`` on the CPU or with ``impl="ref"``), chosen by
``bwd_variant`` (the C launcher's ``gmm_bwd_variant`` applies the same
rule): bf16 with D % 8 == F % 8 == 0, 16-byte aligned x, w, dy, dx and
dw, at most ``MAX_WGMMA_EXPERTS`` experts and the tensor maps' and item
counters' limits on wgmma/TMA; other bf16 on mma.sync; f32 on the CUDA
cores.  ``LAUNCHES["gmm_bwd"]`` counts its calls, "gmm_bwd.dx" and
"gmm_bwd.dw" each kernel's launches and "gmm_bwd.<variant>" the calls of
each variant.  Its ``vmap`` rule folds the member axis into the expert
axis, since members share no experts: one launch for every member.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import (
    count_launch,
    fold_members,
    grad_required,
    transformed,
    unfold_members,
)
from repro_torch.kernels.moe_gmm.ref import gmm_bwd_ref, gmm_ref

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
    plain = impl == "ref" or x.device.type == "cpu"
    if grad_required(x, w) or transformed(x, w, group_sizes):
        return GroupedMatmul.apply(x, w, group_sizes, plain)
    if plain:
        return gmm_ref(x, w, group_sizes)
    return gmm_cuda(x, w, group_sizes)


def bwd_variant(dtype: torch.dtype, E: int, C: int, D: int, F: int,
                aligned: bool = True) -> str:
    """The backward kernels a ``gmm_bwd_cuda`` call takes; ``aligned``: x,
    w, dy and the gradients start on a 16-byte boundary.  The wgmma
    kernels' further limits: a tensor map's strides stay under 2^40 bytes
    (C * D, C * F, D * F < 2^39 bf16) and each product's items (dx: up to
    128 rows at C <= 128, else 384, x 128 columns of D; dw: 64 rows of D at
    C <= 128, else 128, x 256 columns of F; counted for all E experts)
    number fewer than 2^31."""
    if dtype == torch.float32:
        return "f32"
    strides = 2 ** 39
    if (D % 8 == 0 and F % 8 == 0 and aligned and E <= MAX_WGMMA_EXPERTS
            and max(C * D, C * F, D * F) < strides
            and E * -(-C // (128 if C <= 128 else 384)) * -(-D // 128)
            < 2 ** 31
            and E * -(-D // (64 if C <= 128 else 128)) * -(-F // 256)
            < 2 ** 31):
        return "wgmma"
    return "mma_sync"


class GroupedMatmul(torch.autograd.Function):
    """out = gmm(x, w, group_sizes); saves x, w and the sizes.  The
    backward gives dx and dw (no gradient for the sizes).  ``plain``: the
    plain versions instead of the kernels."""

    @staticmethod
    def forward(x, w, group_sizes, plain):
        if plain:
            return gmm_ref(x, w, group_sizes)
        return gmm_cuda(x, w, group_sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, group_sizes, plain = inputs
        ctx.save_for_backward(x, w, group_sizes)
        ctx.plain = plain

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        if ctx.plain:
            dx, dw = gmm_bwd_ref(x, w, group_sizes, dy)
        else:
            need_dx, need_dw = ctx.needs_input_grad[:2]
            dx, dw = gmm_bwd_cuda(x, w, group_sizes, dy.contiguous(),
                                  need_dx=need_dx, need_dw=need_dw)
        return dx, dw, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, group_sizes, plain):
        """Fold the member axis into the expert axis, (N, E, ...) ->
        (N * E, ...): members share no experts, so one launch computes
        every member's product (and, through this Function, its
        gradients).  An argument that is not batched is expanded to every
        member first; for w that is a copy of N * E expert weights."""
        n = info.batch_size
        out = GroupedMatmul.apply(*(fold_members(t, d, n).contiguous()
                                    for t, d in zip((x, w, group_sizes),
                                                    in_dims[:3])), plain)
        return unfold_members(out, n), 0


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


def gmm_bwd_cuda(x, w, group_sizes, dy, *, need_dx=True, need_dw=True):
    """Launch the backward kernels on ``torch.cuda.current_stream()``:
    (dx (E, C, D) in x's dtype, rows past the sizes exactly 0; dw (E, D, F)
    in w's) from the forward's inputs and the output gradient dy (E, C, F)
    in x's dtype.  dy's padding rows are never read.  A gradient not
    needed is not computed (None in its place)."""
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes),
                    ("dy", dy)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs CUDA")
        if t.device != x.device:
            raise ValueError("x, w, group_sizes, dy must be on one device")
    check_inputs(x, w, group_sizes)
    E, C, D = x.shape
    F = w.shape[2]
    if dy.shape != (E, C, F) or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous {(E, C, F)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    outs = [t for t in (dx, dw) if t is not None]
    if not outs:
        return dx, dw
    if 0 in (C, D, F):   # nothing to sum: the kernels take no empty axis
        for t in outs:
            t.zero_()
        return dx, dw
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, dy, *outs))
    vec = int(D % 8 == 0 and F % 8 == 0 and aligned)
    kind = bwd_variant(x.dtype, E, C, D, F, aligned)
    lib = _library("gmm_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gmm_bwd(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                          dy.data_ptr(), None if dx is None else dx.data_ptr(),
                          None if dw is None else dw.data_ptr(),
                          _DTYPES[x.dtype], E, C, D, F, vec, stream)
    if err:
        msg = lib.gmm_bwd_error_string(err).decode()
        raise RuntimeError(f"gmm_bwd launch failed: {msg} ({err})")
    count_launch("gmm_bwd", f"gmm_bwd.{kind}",
                 *(f"gmm_bwd.{n}" for n, t in (("dx", dx), ("dw", dw))
                   if t is not None))
    return dx, dw


_ARGTYPES = {   # library: its launch entry's pointer and int arguments
    "gmm": (4, 6),        # x w sizes out; dtype E C D F vec
    "gmm_bwd": (6, 6),    # x w sizes dy dx dw; dtype E C D F vec
}


def _library(name: str = "gmm"):
    """The loaded library ``name`` (gmm or gmm_bwd), its C entries typed."""
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


def kernel_bwd_variant(dtype: torch.dtype, E: int, C: int, D: int, F: int,
                       aligned: bool = True) -> str:
    """The backward variant the built library's launcher picks (needs
    nvcc)."""
    fn = _library("gmm_bwd").gmm_bwd_variant
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    vec = int(D % 8 == 0 and F % 8 == 0 and aligned)
    code = fn(_DTYPES[dtype], E, C, D, F, vec)
    if code < 0:
        raise ValueError(f"no gmm_bwd kernel takes {dtype}")
    return VARIANTS[code]


def kernel_bwd_smem_bytes() -> dict:
    """Dynamic shared memory per block of the wgmma dx and dw kernels, as
    the built library states it (needs nvcc)."""
    fn = _library("gmm_bwd").gmm_bwd_wgmma_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return {"gmm_bwd_dx_wgmma<1>": fn(0), "gmm_bwd_dx_wgmma<3>": fn(1),
            "gmm_bwd_dw_pp_wgmma": fn(2), "gmm_bwd_dw_wgmma": fn(3)}
