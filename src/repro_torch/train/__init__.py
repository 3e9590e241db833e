from repro_torch.train.losses import chunked_softmax_xent  # noqa: F401
from repro_torch.train.step import (  # noqa: F401
    TrainHyper,
    build_eval_step,
    build_train_step,
    compute_cast,
    make_train_state,
)
