from repro_torch.kernels.moe_gmm.ops import gmm  # noqa: F401
from repro_torch.kernels.moe_gmm.ref import gmm_bwd_ref, gmm_ref  # noqa: F401
