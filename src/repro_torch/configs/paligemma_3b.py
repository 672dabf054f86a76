"""paligemma-3b [vlm] — SigLIP + gemma backbone.  The SigLIP frontend is a
STUB: input_specs() feeds 256 precomputed patch embeddings that occupy the
first 256 positions of the sequence.  [arXiv:2407.07726; hf]

Counterpart of ``repro.configs.paligemma_3b`` (a copy)."""
from repro_torch.configs.base import ModelConfig, RunConfig, reduce_config

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    block_pattern=("G",),
    act="gelu",
    glu=True,
    scale_embeds=True,
    frontend="vision",
    n_frontend_tokens=256,
    rope_theta=10000.0,
)

REDUCED = reduce_config(CONFIG)

RUN = RunConfig(serve_replicated=True)
