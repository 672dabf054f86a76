from repro_torch.train.train_step import (  # noqa: F401
    init_state, make_decode_step, make_prefill_step, make_train_step,
    shard_state, state_shardings, unshard_state)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
