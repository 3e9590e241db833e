"""PyTorch/CUDA port of the ``repro`` package.

The JAX package under ``src/repro`` is the reference; this package mirrors
its module and function names, keeps its public layouts (activations
``(B, S, D)``, heads ``(B, S, H, head_dim)``) and replaces each Pallas TPU
kernel by a hand-written CUDA kernel for Hopper (``sm_90a``).  It imports
``torch`` and numpy only, never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper uses its plain PyTorch
version.
"""
from repro_torch.flags import resolve_device  # noqa: F401
