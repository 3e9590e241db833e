from repro_torch.kernels.mamba.ops import selective_scan, selective_step  # noqa: F401
from repro_torch.kernels.mamba.ref import selective_scan_ref  # noqa: F401
