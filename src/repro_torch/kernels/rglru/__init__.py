from repro_torch.kernels.rglru.ops import linear_scan  # noqa: F401
from repro_torch.kernels.rglru.ref import (  # noqa: F401
    linear_scan_bwd_ref,
    linear_scan_ref,
)
