from repro_torch.train.optimizer import OptConfig, init_opt_state, apply_updates, lr_at  # noqa: F401
from repro_torch.train.train_step import TrainState, make_train_step, make_init_state  # noqa: F401
