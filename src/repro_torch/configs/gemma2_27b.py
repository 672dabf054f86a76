"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]

Counterpart of ``repro.configs.gemma2_27b`` (a copy)."""
from repro_torch.configs.base import ModelConfig, RunConfig, reduce_config

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab=256000,
    block_pattern=("L", "G"),      # 1:1 local/global alternation (23 blocks)
    window=4096,
    logit_softcap=30.0,
    attn_softcap=50.0,
    attn_scale=(4608 / 32) ** -0.5,  # query_pre_attn_scalar = d_model/n_heads
    act="gelu",
    glu=True,
    scale_embeds=True,
    post_norm=True,
    rope_theta=10000.0,
)

REDUCED = reduce_config(CONFIG)

RUN = RunConfig(grad_accum=1)
