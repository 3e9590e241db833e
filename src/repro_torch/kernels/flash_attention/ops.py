"""Public flash-attention entry point with device dispatch.

A CPU tensor goes to the plain PyTorch version (``ref``).  A CUDA tensor goes
to the hand-written Hopper kernels (``csrc/flash_attention_fwd.cu``), or to
``ref`` only when ``impl="ref"`` is passed explicitly.  Nothing falls back:
a CUDA input the kernels do not take raises.

Which kernel a launch takes is fixed by dtype and head dim (``variant``):
bf16 with D in 64, 128, 256 runs the wgmma/TMA kernel, bf16 with D in 16,
32 the mma.sync kernel (a 32- or 64-byte row is below TMA's 128-byte
swizzle atom), f32 the CUDA-core kernel.  ``LAUNCHES["flash_attention"]``
counts every launch, ``LAUNCHES["flash_attention.<variant>"]`` each
variant's.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)    # instantiated in the kernel
MAX_GROUP = 64                        # q heads per kv head (rows per block)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head_dim); the C launcher's rule."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if head_dim >= 64 else "mma_sync"


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    q_offset: int = 0, seg_q=None, seg_kv=None,
                    impl: Optional[str] = None):
    """q: (B, Sq, H, D); k/v: (B, Sk, KH, D).  Returns (B, Sq, H, D).

    ``impl``: None (the tensor's device decides) or "ref".
    """
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    if impl not in (None, "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "ref" or q.device.type == "cpu":
        return attention_ref(q, k, v, seg_q=seg_q, seg_kv=seg_kv, **kw)
    if seg_q is not None or seg_kv is not None:
        raise NotImplementedError(
            "segment ids: the CUDA kernel does not take them yet")
    return flash_attention_cuda(q, k, v, **kw)


def check_inputs(q, k, v) -> None:
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


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale: Optional[float] = None,
                         q_offset: int = 0):
    """Launch the Hopper kernel on ``torch.cuda.current_stream()``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs CUDA")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    check_inputs(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel reads 16-byte chunks)")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return o
    if Sk == 0:          # no keys: every row fully masked, as in ref
        return o.zero_()
    kind = variant(q.dtype, D)
    scale = scale if scale is not None else D ** -0.5
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Sk, H, KH, D, int(bool(causal)),
            int(window), float(softcap), float(scale), int(q_offset), stream)
    if err:
        msg = lib.flash_attention_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({err})")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention.{kind}"] += 1
    return o


def _library():
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
                       i32, i32, ctypes.c_float, ctypes.c_float, i32, ptr]
        fn.restype = i32
        lib.flash_attention_fwd_error_string.argtypes = [i32]
        lib.flash_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


def kernel_smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory per block of the kernel that takes (dtype,
    head_dim), as the built library states it (needs nvcc)."""
    fn = _library().flash_attention_fwd_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = fn(_DTYPES[dtype], head_dim)
    if out < 0:
        raise ValueError(f"no kernel takes {dtype}, D={head_dim}")
    return out
