from repro_torch.serve.engine import (  # noqa: F401
    BatchedServer,
    Request,
    build_prefill_step,
    build_serve_step,
)
