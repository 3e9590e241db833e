from repro_torch.checkpoint.checkpoint import Checkpointer  # noqa: F401
