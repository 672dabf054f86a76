"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]

Counterpart of ``repro.configs.qwen3_moe_235b_a22b`` (a copy)."""
from repro_torch.configs.base import (
    ModelConfig, MoECfg, RunConfig, reduce_config)

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,                     # per-expert hidden dim
    vocab=151936,
    block_pattern=("G",),
    moe=MoECfg(n_experts=128, top_k=8, d_ff=1536, capacity_factor=1.25),
    act="silu",
    glu=True,
    rope_theta=1_000_000.0,
)

REDUCED = reduce_config(CONFIG)

RUN = RunConfig(adam_dtype="bfloat16", grad_accum=4)
