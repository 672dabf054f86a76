"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]

Counterpart of ``repro.configs.dbrx_132b`` (a copy)."""
from repro_torch.configs.base import (
    ModelConfig, MoECfg, RunConfig, reduce_config)

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,                    # per-expert hidden dim
    vocab=100352,
    block_pattern=("G",),
    moe=MoECfg(n_experts=16, top_k=4, d_ff=10752, capacity_factor=1.25),
    act="silu",
    glu=True,
    rope_theta=500_000.0,
)

REDUCED = reduce_config(CONFIG)

RUN = RunConfig(adam_dtype="bfloat16", grad_accum=2)
