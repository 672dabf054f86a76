"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; hf]

Counterpart of ``repro.configs.h2o_danube_1_8b`` (a copy)."""
from repro_torch.configs.base import ModelConfig, RunConfig, reduce_config

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=80,
    d_ff=6912,
    vocab=32000,
    block_pattern=("L",),          # SWA on every layer => sub-quadratic
    window=4096,
    act="silu",
    glu=True,
    rope_theta=10000.0,
)

REDUCED = reduce_config(CONFIG)

RUN = RunConfig(serve_replicated=True)
