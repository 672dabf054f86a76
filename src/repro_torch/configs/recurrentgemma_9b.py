"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent blocks
per 1 local-attention block ([R,R,L] x 12 + [R,R] tail = 38 layers).
[arXiv:2402.19427]

Counterpart of ``repro.configs.recurrentgemma_9b`` (a copy)."""
from repro_torch.configs.base import ModelConfig, RunConfig, reduce_config

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,                  # MQA
    d_head=256,
    d_ff=12288,
    vocab=256000,
    block_pattern=("R", "R", "L"),
    tail=("R", "R"),
    window=2048,
    rglru_width=4096,
    act="gelu",
    glu=True,
    scale_embeds=True,
    rope_theta=10000.0,
)

REDUCED = reduce_config(CONFIG)

RUN = RunConfig(serve_replicated=True)
