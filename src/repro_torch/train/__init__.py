"""Training: AdamW with a warmup-cosine schedule and the train loop."""
from repro_torch.train.loop import make_train_step, train, trainable  # noqa: F401
from repro_torch.train.optimizer import (  # noqa: F401
    OptConfig,
    OptState,
    adamw_update,
    init_opt_state,
    lr_at,
)
