"""Public Mamba selective-scan entry point with device dispatch, and the
single-token decode step.

A CPU tensor goes to the plain PyTorch version (``ref``).  A CUDA tensor goes
to the hand-written Hopper kernel (``csrc/selective_scan.cu``), or to ``ref``
only when ``impl="ref"`` is passed explicitly.  Nothing falls back: a CUDA
input the kernel does not take raises.

When autograd records the call (or the inputs come wrapped by
``torch.func.vmap``) ``selective_scan`` runs through ``SelectiveScan``, an
``autograd.Function``: its forward kernel also writes the states at every
``CKPT_STEPS``-th step, and its backward kernel
(``csrc/selective_scan_bwd.cu``; ``selective_scan_bwd_ref`` on the CPU or
with ``impl="ref"``) recomputes the states between them and runs the
reverse recurrence.  ``LAUNCHES["selective_scan_bwd"]`` counts its
launches.  A and D are weights: the ``vmap`` rule folds the member axis
into the batch when they are the same for every member, and otherwise
launches once per member.

``selective_step`` is the plain counterpart of ``selective_step_xla``; the
JAX package has no Pallas kernel for it, so it stays plain torch.

``cost`` and ``bwd_cost`` give each kernel's (FLOPs, bytes); on fake
tensors the launchers make their outputs and workspaces (``part_bc``,
``part_ad``), count the call in ``FAKE_CALLS`` with its cost, and return
before the library (``kernels.is_fake``).
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
from repro_torch.kernels.mamba.ref import (
    selective_scan_bwd_ref,
    selective_scan_ref,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16          # the kernel keeps n <= 16 states per thread
CKPT_STEPS = 8          # steps between the states the forward keeps for
                        # the backward (kK in selective_scan_bwd.cu)
BWD_CHANNELS = 128      # channels per block of the backward kernel
BWD_STATES = 16         # the backward kernel pads n to 16 states (4 lanes
                        # of 4 a channel)


def variant(n: int) -> str:
    """The kernel instantiation that takes state size ``n``: "np<NP>", n
    padded to NP = 4, 8 or 16 states."""
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size {n}; the kernel takes 1..{MAX_STATE}")
    return f"np{4 if n <= 4 else 8 if n <= 8 else 16}"


def cost(B: int, T: int, d: int, n: int, itemsize: int, bc_itemsize: int,
         *, checkpoints: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one forward call: 7 n + 3 flops a step and channel;
    x read and y written in x's dtype, dt, A, D read in f32, Bm and C read
    in their dtype, h0 read and h_last written in f32, and with
    ``checkpoints`` the states kept every ``CKPT_STEPS`` steps written.
    (Its B * T * d * n exponentials are the special-function units' work,
    which ``chip_smoke.py`` holds apart.)"""
    nbytes = (2 * B * T * d * itemsize + B * T * d * 4 + d * n * 4
              + 2 * B * T * n * bc_itemsize + d * 4 + 2 * B * d * n * 4)
    if checkpoints:
        nbytes += 4 * B * -(-T // CKPT_STEPS) * d * n
    return float(B * T * d * (7 * n + 3)), float(nbytes)


def bwd_cost(B: int, T: int, d: int, n: int, itemsize: int,
             bc_itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one backward call: 22 n + 10 flops a step and
    channel; inputs x, dt, A, Bm, C, D, h0, dy, dh_last read once and
    dx, ddt, dA, dBm, dC, dD, dh0 written once (the checkpoints and the
    partial sums are the design's, not the function's)."""
    bc = B * T * n * bc_itemsize
    nbytes = (2 * B * T * d * itemsize + 2 * B * T * d * 4 + 4 * bc
              + 4 * (2 * d * n + 2 * d) + 4 * 4 * B * d * n)
    return float(B * T * d * (22 * n + 10)), float(nbytes)


def selective_scan(x, dt, A, Bm, C, D, h0, *, impl: Optional[str] = None):
    """x, dt: (B, T, d); A: (d, n); Bm, C: (B, T, n); D: (d,); h0: (B, d, n).

    Returns (y (B, T, d) in x's dtype, h_last (B, d, n)).  ``impl``: None
    (the tensor's device decides) or "ref".
    """
    if impl not in (None, "ref"):
        raise ValueError(f"unknown selective-scan impl {impl!r}")
    plain = impl == "ref" or x.device.type == "cpu"
    args = (x, dt, A, Bm, C, D, h0)
    if grad_required(*args) or transformed(*args):
        y, h_last, _ = SelectiveScan.apply(*args, plain)
        return y, h_last
    if plain:
        return selective_scan_ref(*args)
    return selective_scan_cuda(*args)


class SelectiveScan(torch.autograd.Function):
    """(y, h_last, ckpt) = selective_scan(...) and the states every
    ``CKPT_STEPS`` steps (B, ceil(T / CKPT_STEPS), d, n) for the backward
    kernel ((B, 0) on the plain path, which recomputes from h0); saves the
    inputs and ckpt.  ``plain``: the plain versions instead of the
    kernels."""

    @staticmethod
    def forward(x, dt, A, Bm, C, D, h0, plain):
        if plain:
            y, h_last = selective_scan_ref(x, dt, A, Bm, C, D, h0)
            return y, h_last, h0.new_empty((x.shape[0], 0))
        return selective_scan_cuda(x, dt, A, Bm, C, D, h0, checkpoints=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *args, plain = inputs
        ctx.mark_non_differentiable(output[2])
        ctx.save_for_backward(*args, output[2])
        ctx.plain = plain

    @staticmethod
    def backward(ctx, dy, dh_last, _dckpt):
        *args, ckpt = ctx.saved_tensors
        if ctx.plain:
            grads = selective_scan_bwd_ref(*args, dy, dh_last)
        else:
            grads = selective_scan_bwd_cuda(*args, ckpt, dy.contiguous(),
                                            dh_last.contiguous())
        return (*grads, None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bm, C, D, h0, plain):
        """Members that share A and D fold into the batch (one launch);
        per-member A and D take one launch a member."""
        n = info.batch_size
        args, dims = (x, dt, A, Bm, C, D, h0), in_dims[:7]
        if dims[2] is None and dims[5] is None:
            folded = [t if i in (2, 5) else fold_members(t, d, n)
                      for i, (t, d) in enumerate(zip(args, dims))]
            out = SelectiveScan.apply(*folded, plain)
            return tuple(unfold_members(t, n) for t in out), (0, 0, 0)
        outs = [SelectiveScan.apply(
            *(t if d is None else t.select(d, i) for t, d in zip(args, dims)),
            plain) for i in range(n)]
        return tuple(torch.stack(ts) for ts in zip(*outs)), (0, 0, 0)


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


def selective_scan_cuda(x, dt, A, Bm, C, D, h0, *, checkpoints: bool = False):
    """Launch the Hopper kernel on ``torch.cuda.current_stream()``.  With
    ``checkpoints`` it also writes the states before every
    ``CKPT_STEPS``-th step, (B, ceil(T / CKPT_STEPS), d, n) float32, and
    returns (y, h_last, ckpt)."""
    fake = is_fake(x, dt, A, Bm, C, D, h0)
    check_device(fake, x=x, dt=dt, A=A, Bm=Bm, C=C, D=D, h0=h0)
    check_inputs(x, dt, A, Bm, C, D, h0)
    B, T, d = x.shape
    n = A.shape[1]
    y = torch.empty_like(x)
    ckpt = (torch.empty((B, -(-T // CKPT_STEPS), d, n), dtype=torch.float32,
                        device=x.device) if checkpoints else None)
    if B * d == 0 or T == 0:
        return (y, h0.clone(), ckpt) if checkpoints else (y, h0.clone())
    h_last = torch.empty_like(h0)
    if fake:
        count_fake(cost(B, T, d, n, x.element_size(), Bm.element_size(),
                        checkpoints=checkpoints), "selective_scan")
        return (y, h_last, ckpt) if checkpoints else (y, h_last)
    lib = _library()
    ptrs = [t.data_ptr() for t in (x, dt, A, Bm, C, D, h0, y, h_last)]
    ints = [_DTYPES[x.dtype], _DTYPES[Bm.dtype], B, T, d, n]
    strides = [Bm.stride(0), Bm.stride(1), C.stride(0), C.stride(1)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if ckpt is None:
            err = lib.selective_scan(*ptrs, *ints, *strides, stream)
        else:
            err = lib.selective_scan_ckpt(*ptrs, ckpt.data_ptr(), *ints,
                                          CKPT_STEPS, *strides, stream)
    if err:
        msg = lib.selective_scan_error_string(err).decode()
        raise RuntimeError(f"selective_scan launch failed: {msg} ({err})")
    count_launch("selective_scan")
    return (y, h_last, ckpt) if checkpoints else (y, h_last)


def selective_scan_bwd_cuda(x, dt, A, Bm, C, D, h0, ckpt, dy, dh_last):
    """Launch the backward kernels on ``torch.cuda.current_stream()``:
    (dx, ddt, dA, dBm, dC, dD, dh0) from the forward's inputs, the states
    it kept (``selective_scan_cuda(..., checkpoints=True)``) and the output
    gradients dy (x's dtype) and dh_last (float32).  dBm and dC come back
    contiguous in Bm's dtype, the others in their inputs' dtypes."""
    fake = is_fake(x, dt, A, Bm, C, D, h0, ckpt, dy, dh_last)
    check_device(fake, x=x, dt=dt, A=A, Bm=Bm, C=C, D=D, h0=h0, ckpt=ckpt,
                 dy=dy, dh_last=dh_last)
    check_inputs(x, dt, A, Bm, C, D, h0)
    B, T, d = x.shape
    n = A.shape[1]
    for name, t, shape, dtype in (
            ("ckpt", ckpt, (B, -(-T // CKPT_STEPS), d, n), torch.float32),
            ("dy", dy, x.shape, x.dtype),
            ("dh_last", dh_last, h0.shape, torch.float32)):
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {tuple(shape)} "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dBm = torch.empty((B, T, n), dtype=Bm.dtype, device=x.device)
    dC = torch.empty_like(dBm)
    dA, dD, dh0 = torch.empty_like(A), torch.empty_like(D), torch.empty_like(h0)
    if B * d == 0 or T == 0:
        return (dx, ddt, dA.zero_(), dBm.zero_(), dC.zero_(), dD.zero_(),
                dh_last.clone())
    nblk = -(-d // BWD_CHANNELS)
    # per-block partial sums of dBm and dC over its channels, and per-row
    # ones of dA and dD over T: summed in a fixed order by the last kernels
    part_bc = torch.empty((B, nblk, T, 2 * BWD_STATES), dtype=torch.float32,
                          device=x.device)
    part_ad = torch.empty((B, d, n + 1), dtype=torch.float32, device=x.device)
    if fake:
        count_fake(bwd_cost(B, T, d, n, x.element_size(), Bm.element_size()),
                   "selective_scan_bwd")
        return dx, ddt, dA, dBm, dC, dD, dh0
    lib = _library("selective_scan_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.selective_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), D.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
            dh_last.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dBm.data_ptr(), dC.data_ptr(), dD.data_ptr(), dh0.data_ptr(),
            part_bc.data_ptr(), part_ad.data_ptr(), _DTYPES[x.dtype],
            _DTYPES[Bm.dtype], B, T, d, n, CKPT_STEPS, Bm.stride(0),
            Bm.stride(1), C.stride(0), C.stride(1), stream)
    if err:
        msg = lib.selective_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"selective_scan_bwd launch failed: {msg} ({err})")
    count_launch("selective_scan_bwd")
    return dx, ddt, dA, dBm, dC, dD, dh0


def kernel_bwd_smem_bytes() -> int:
    """Dynamic shared memory per block of the backward kernel, as the built
    library states it (needs nvcc)."""
    fn = _library("selective_scan_bwd").selective_scan_bwd_smem_bytes
    fn.restype = ctypes.c_int
    return fn()


# C entry: its pointer arguments, then int ones (dtypes, B, T, d, n and, but
# for selective_scan, the checkpoint stride), then the four Bm / C strides
# (long long) and the stream
_ENTRIES = {"selective_scan": {"selective_scan": (9, 6),
                               "selective_scan_ckpt": (10, 7)},
            "selective_scan_bwd": {"selective_scan_bwd": (18, 7)}}


def _library(name: str = "selective_scan"):
    """The loaded library ``name`` (selective_scan or selective_scan_bwd),
    its C entries typed."""
    from repro_torch.kernels import _build
    lib = _build.load(name)
    entries = _ENTRIES[name]
    if getattr(lib, name).argtypes is None:
        # the entry named like the library is typed last: a thread that
        # sees it typed sees all; an older source (a --baseline of
        # chip_smoke.py) may lack selective_scan_ckpt
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        for entry, (n_ptr, n_int) in reversed(entries.items()):
            fn = getattr(lib, entry, None)
            if fn is not None:
                fn.restype = i32
                fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [i64] * 4 \
                    + [ptr]
    return lib
