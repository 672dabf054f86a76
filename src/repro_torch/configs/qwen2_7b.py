"""qwen2-7b [dense] — GQA kv=4, QKV bias. [arXiv:2407.10671; hf]

Counterpart of ``repro.configs.qwen2_7b`` (a copy)."""
from repro_torch.configs.base import ModelConfig, RunConfig, reduce_config

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab=152064,
    block_pattern=("G",),
    qkv_bias=True,
    act="silu",
    glu=True,
    rope_theta=1_000_000.0,
)

REDUCED = reduce_config(CONFIG)

RUN = RunConfig(serve_replicated=True)
