"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.
d_inner = 2*2560 = 5120, head_dim 64 => 80 SSD heads, state 128.
[arXiv:2405.21060]

Counterpart of ``repro.configs.mamba2_2_7b`` (a copy)."""
from repro_torch.configs.base import (
    ModelConfig, RunConfig, SSMCfg, reduce_config)

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,                     # attention-free
    n_kv_heads=0,
    d_head=0,
    d_ff=0,                        # no MLP — SSD blocks only
    vocab=50280,
    block_pattern=("S",),
    ssm=SSMCfg(d_state=128, expand=2, head_dim=64, conv_width=4, chunk=128),
    act="silu",
)

REDUCED = reduce_config(CONFIG)

RUN = RunConfig()
