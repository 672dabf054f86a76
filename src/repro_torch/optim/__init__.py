from repro_torch.optim.adamw import (AdamWConfig, adamw_update,  # noqa: F401
                                     init_opt_state, lr_at)
