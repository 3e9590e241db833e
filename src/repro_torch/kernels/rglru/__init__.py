from repro_torch.kernels.rglru.ops import linear_scan  # noqa: F401
from repro_torch.kernels.rglru.ref import linear_scan_ref  # noqa: F401
