from repro_torch.optim.adamw import (  # noqa: F401
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import make_schedule  # noqa: F401
