"""Distribution layer: partition specs as DTensor placements, and
mesh-slot topology (own copy of ``repro.dist``).

``repro_torch.dist.sharding`` decides *how tensors are laid out* on a mesh
(params, optimizer state, batches, decode caches);
``repro_torch.dist.topology`` decides *which ranks a pilot slot owns*
(submesh carving for the ensemble executor); ``repro_torch.dist.spmd``
runs a step on a mesh (local shards, gather on use, collectives).
"""
from repro_torch.dist.sharding import (  # noqa: F401
    abstract_mesh,
    batch_shardings,
    cache_shardings,
    constrain_batch,
    constrain_like_params,
    constrain_logits,
    param_spec,
    state_shardings,
)
from repro_torch.dist.topology import SlotTopology  # noqa: F401
