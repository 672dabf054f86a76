"""glm4-9b [dense] — RoPE, GQA kv=2, QKV bias. [hf:THUDM/glm-4-9b; hf]

Counterpart of ``repro.configs.glm4_9b`` (a copy)."""
from repro_torch.configs.base import ModelConfig, RunConfig, reduce_config

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab=151552,
    block_pattern=("G",),
    qkv_bias=True,                 # GLM-4 add_qkv_bias
    act="silu",
    glu=True,
    rope_theta=10000.0,
)

REDUCED = reduce_config(CONFIG)

RUN = RunConfig(serve_replicated=True)
