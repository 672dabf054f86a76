"""seamless-m4t-medium [audio] — encoder-decoder transformer backbone
(12 enc + 12 dec, matching hf seamless-m4t-medium's text stacks).  The speech
frontend is a STUB: input_specs() feeds precomputed frame embeddings to the
encoder.  [arXiv:2308.11596; hf]

Counterpart of ``repro.configs.seamless_m4t_medium`` (a copy)."""
from repro_torch.configs.base import ModelConfig, RunConfig, reduce_config

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                   # decoder stack (assigned "12L")
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,                 # MHA
    d_head=64,
    d_ff=4096,
    vocab=256206,
    block_pattern=("G",),
    enc_dec=True,
    n_enc_layers=12,
    act="relu",
    glu=False,
    frontend="audio",
    rope_theta=10000.0,
)

REDUCED = reduce_config(CONFIG)

RUN = RunConfig(tp_hint=2, serve_replicated=True)
