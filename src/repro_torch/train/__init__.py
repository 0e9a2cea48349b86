from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state  # noqa: F401
from .train_step import TrainConfig, auto_train_config, make_train_step  # noqa: F401
