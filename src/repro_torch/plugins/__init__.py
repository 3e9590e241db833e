"""Kernel plugin registry: importing this package registers the port's plugins."""
from repro_torch.plugins import lm           # noqa: F401
from repro_torch.plugins import re_exchange  # noqa: F401
from repro_torch.plugins import serve        # noqa: F401
from repro_torch.plugins import synthetic    # noqa: F401
from repro_torch.plugins import toy          # noqa: F401
