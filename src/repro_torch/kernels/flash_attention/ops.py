"""Public flash-attention entry point with device dispatch, and its gradient.

A CPU tensor goes to the plain PyTorch versions (``ref``).  A CUDA tensor
goes to the hand-written Hopper kernels (``csrc/flash_attention_fwd.cu``,
and ``csrc/flash_attention_bwd.cu`` for the gradient), or to ``ref`` only
when ``impl="ref"`` is passed explicitly.  Nothing falls back: a CUDA input
the kernels do not take raises.

When autograd records the call (grad mode on, q, k or v requiring grad),
``flash_attention`` runs through ``FlashAttention``, an
``autograd.Function`` that saves q, k, v, o and the forward's log-sum-exp
and takes dq, dk, dv from the backward kernels (on the CPU, or with
``impl="ref"``: from ``attention_fwd_ref`` and ``attention_bwd_ref``, the
same formula).  Otherwise the forward runs alone, without lse.

Which kernel a launch takes is fixed by dtype and head dim (``variant``):
bf16 with D in 64, 128, 256 runs the wgmma/TMA kernel, bf16 with D in 16,
32 the mma.sync kernel (a 32- or 64-byte row is below TMA's 128-byte
swizzle atom), f32 the CUDA-core kernel.  ``LAUNCHES["flash_attention"]``
counts every launch, ``LAUNCHES["flash_attention.<variant>"]`` each
variant's.  The backward follows the same rule (``bwd_variant``): bf16
with D in 64, 128, 256 runs the persistent wgmma/TMA kernel (dK/dV and dQ
items in one launch, dealt by a schedule that the C launcher builds and
keeps per shape), bf16 with D in 16, 32 the mma.sync kernels, f32 the
CUDA-core kernels; ``LAUNCHES["flash_attention_bwd"]`` and
``LAUNCHES["flash_attention_bwd.<variant>"]`` count its calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES, grad_required
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_fwd_ref,
    attention_ref,
)

HEAD_DIMS = (16, 32, 64, 128, 256)    # instantiated in the kernel
MAX_GROUP = 64                        # q heads per kv head (rows per block)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head_dim); the C launcher's rule."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if head_dim >= 64 else "mma_sync"


bwd_variant = variant   # the backward kernels follow the forward's rule


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    q_offset: int = 0, seg_q=None, seg_kv=None,
                    impl: Optional[str] = None):
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D); seg_q (B, Sq) and seg_kv
    (B, Sk): segment ids, both or neither.  Returns (B, Sq, H, D).

    ``impl``: None (the tensor's device decides) or "ref".
    """
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset, seg_q=seg_q, seg_kv=seg_kv)
    if impl not in (None, "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if (seg_q is None) != (seg_kv is None):
        raise ValueError("pass both seg_q and seg_kv, or neither")
    if grad_required(q, k, v):
        return FlashAttention.apply(q, k, v, impl, kw)
    if impl == "ref" or q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    return flash_attention_cuda(q, k, v, **kw)


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v); saves q, k, v, o and lse for the backward.
    ``kw``: the masks' arguments of ``flash_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, impl, kw):
        plain = impl == "ref" or q.device.type == "cpu"
        if plain:
            o, lse = attention_fwd_ref(q, k, v, **kw)
        else:
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.plain, ctx.kw = plain, kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = attention_bwd_ref if ctx.plain else flash_attention_bwd_cuda
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None


def _check_segments(seg_q, seg_kv, B, Sq, Sk) -> None:
    if seg_q is None and seg_kv is None:
        return
    if seg_q is None or seg_kv is None:
        raise ValueError("pass both seg_q and seg_kv, or neither")
    for name, t, S in (("seg_q", seg_q, Sq), ("seg_kv", seg_kv, Sk)):
        if t.shape != (B, S) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({B}, {S}) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_inputs(q, k, v, seg_q=None, seg_kv=None) -> None:
    """Raise on what the kernel does not take (device aside)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D: (B, S, heads, head_dim)")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    KH = k.shape[2]
    if KH == 0 or H % KH:
        raise ValueError(f"q heads {H} not a multiple of kv heads {KH}")
    if H // KH > MAX_GROUP:
        raise ValueError(f"{H // KH} q heads per kv head; at most {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must match and be float32 or bfloat16: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B * KH > 65535:
        raise ValueError(f"batch x kv heads {B * KH} exceeds the grid limit")
    _check_segments(seg_q, seg_kv, B, q.shape[1], k.shape[1])


def _on_cuda(**tensors) -> None:
    """Raise unless every tensor given lies on one CUDA device, starting on
    a 16-byte boundary (the kernels read 16-byte chunks)."""
    dev = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs CUDA")
        if dev is not None and t.device != dev:
            raise ValueError(f"{', '.join(tensors)} must be on one device")
        dev = t.device
        if t.data_ptr() % 16 and t.dtype != torch.int32:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel reads 16-byte chunks)")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale: Optional[float] = None,
                         q_offset: int = 0, seg_q=None, seg_kv=None,
                         return_lse: bool = False):
    """Launch the Hopper kernel on ``torch.cuda.current_stream()``.  With
    ``return_lse`` returns (o, lse (B, H, Sq) f32), else o."""
    _on_cuda(q=q, k=k, v=v, seg_q=seg_q, seg_kv=seg_kv)
    check_inputs(q, k, v, seg_q, seg_kv)
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B == 0 or Sq == 0 or Sk == 0:   # no keys: rows fully masked, as ref
        o.zero_()
        if lse is not None:
            lse.fill_(float("-inf"))
        return (o, lse) if return_lse else o
    kind = variant(q.dtype, D)
    scale = scale if scale is not None else D ** -0.5
    lib = _library("flash_attention_fwd")
    args = (_DTYPES[q.dtype], B, Sq, Sk, H, KH, D, int(bool(causal)),
            int(window), float(softcap), float(scale), int(q_offset))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_seg(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _ptr(seg_q), _ptr(seg_kv), _ptr(lse), *args, stream)
    if err:
        msg = lib.flash_attention_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({err})")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention.{kind}"] += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             scale: Optional[float] = None, q_offset: int = 0,
                             seg_q=None, seg_kv=None):
    """Launch the backward kernels on ``torch.cuda.current_stream()``:
    (dq, dk, dv) from the forward's o and lse (``flash_attention_cuda``
    with the same arguments and ``return_lse``) and the output gradient
    do."""
    _on_cuda(q=q, k=k, v=v, o=o, lse=lse, do=do, seg_q=seg_q, seg_kv=seg_kv)
    check_inputs(q, k, v, seg_q, seg_kv)
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, of q's shape and "
                             f"dtype: {tuple(t.shape)} {t.dtype}")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous ({B}, {H}, {Sq}) float32, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    if B * H > 65535:
        raise ValueError(f"batch x heads {B * H} exceeds the grid limit")
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    if B == 0 or Sq == 0 or Sk == 0:   # nothing is live: zero gradients
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else D ** -0.5
    lib = _library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), _ptr(seg_q), _ptr(seg_kv),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Sk, H, KH, D, int(bool(causal)),
            int(window), float(softcap), float(scale), int(q_offset), stream)
    if err:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd launch failed: {msg} ({err})")
    LAUNCHES["flash_attention_bwd"] += 1
    LAUNCHES[f"flash_attention_bwd.{bwd_variant(q.dtype, D)}"] += 1
    return dq, dk, dv


_ENTRY = {   # library: its launch entry, its pointer args before SCALARS
    "flash_attention_fwd": ("flash_attention_fwd_seg", 7),
    "flash_attention_bwd": ("flash_attention_bwd", 12),
}
# (dtype, B, Sq, Sk, H, KH, D, causal, window, softcap, scale, q_offset,
# stream): the arguments that follow the pointers in every launch entry
SCALARS = [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p]


def _library(name: str):
    """The loaded library ``name`` (flash_attention_fwd or _bwd), its C
    entries typed."""
    from repro_torch.kernels import _build
    lib = _build.load(name)
    entry, n_ptrs = _ENTRY[name]
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + SCALARS
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def kernel_smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory per block of the kernel that takes (dtype,
    head_dim), as the built library states it (needs nvcc)."""
    fn = _library("flash_attention_fwd").flash_attention_fwd_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = fn(_DTYPES[dtype], head_dim)
    if out < 0:
        raise ValueError(f"no kernel takes {dtype}, D={head_dim}")
    return out


def kernel_bwd_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory per block of the wgmma backward kernel at
    ``head_dim`` (64, 128 or 256), as the built library states it (needs
    nvcc)."""
    fn = _library("flash_attention_bwd").flash_attention_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    out = fn(head_dim)
    if out < 0:
        raise ValueError(f"no wgmma backward kernel takes D={head_dim}")
    return out
