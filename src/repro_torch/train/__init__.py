"""Training substrate: optimizer (AdamW + WSD, int8 state), train step."""

from repro_torch.train.optimizer import OptConfig, apply_updates, init_state, lr_at  # noqa: F401
from repro_torch.train.train_step import make_eval_step, make_train_step  # noqa: F401
