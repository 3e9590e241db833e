"""Kernel plugin registry: importing this package registers the port's plugins."""
from repro_torch.plugins import lm  # noqa: F401
