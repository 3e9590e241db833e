from repro_torch.kernels.mamba.ops import selective_scan, selective_step  # noqa: F401
from repro_torch.kernels.mamba.ref import (  # noqa: F401
    selective_scan_bwd_ref,
    selective_scan_ref,
)
