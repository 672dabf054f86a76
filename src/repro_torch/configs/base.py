"""Config system: model architecture, input shapes, runtime knobs.

Counterpart of ``repro.configs.base`` (a copy: the port imports nothing of
the JAX package).

Every assigned architecture gets one module in this package defining CONFIG
(the exact published configuration) and REDUCED (same family, tiny — for CPU
smoke tests).  Select with ``--arch <id>`` in the launchers.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 128               # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int                  # decoder layers (enc-dec: decoder stack)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # layer structure: block_pattern repeated, then tail.  kinds:
    #   G global attn, L local/SWA attn, R RG-LRU block, S Mamba2 SSD block
    block_pattern: tuple = ("G",)
    tail: tuple = ()
    window: int = 0                # local-attention window (kind L)
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    attn_scale: float = 0.0        # 0 => 1/sqrt(d_head)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    act: str = "silu"
    glu: bool = True
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    # encoder-decoder (audio):
    enc_dec: bool = False
    n_enc_layers: int = 0
    # modality frontend STUB: precomputed embeddings fed via input_specs
    frontend: str = ""             # "" | "vision" | "audio"
    n_frontend_tokens: int = 0
    tie_embeddings: bool = True
    scale_embeds: bool = False     # gemma-style sqrt(d_model) embed scaling
    post_norm: bool = False        # gemma2 sandwich norms
    norm_eps: float = 1e-6
    rglru_width: int = 0
    rglru_conv: int = 4
    unroll: bool = False           # python-loop layers (reduced/FT configs)

    @property
    def body_layers(self) -> int:
        return self.n_layers - len(self.tail)

    @property
    def n_blocks(self) -> int:
        assert self.body_layers % len(self.block_pattern) == 0, (
            f"{self.name}: {self.body_layers} body layers do not tile "
            f"pattern {self.block_pattern}")
        return self.body_layers // len(self.block_pattern)

    @property
    def segments(self) -> tuple:
        """Scanned layer segments: ((pattern, n_repeats), ...).  The tail is
        its own scan when homogeneous (it always is in the assigned pool)."""
        segs = [(tuple(self.block_pattern), self.n_blocks)]
        if self.tail:
            kinds = set(self.tail)
            assert len(kinds) == 1, "heterogeneous tail unsupported"
            segs.append(((self.tail[0],), len(self.tail)))
        return tuple(segs)

    @property
    def sub_quadratic(self) -> bool:
        """True when no layer does full-context attention (long_500k rule)."""
        kinds = set(self.block_pattern) | set(self.tail)
        if self.enc_dec:
            return False
        return "G" not in kinds

    def supports(self, shape: "ShapeConfig") -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime/parallelism knobs (overridable per arch and per shape)."""
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    adam_dtype: str = "float32"    # m/v accumulator dtype (bf16 for huge MoE)
    grad_accum: int = 1            # microbatch scan steps per train step
    attn_block: int = 512          # chunked-attention block size
    loss_chunk: int = 512          # tokens per vocab-projection chunk
    remat: str = "block"           # none | block — checkpoint each layer block
    moe_shard_map: bool = True     # partial-sum EP via shard_map
    seq_shard_attn: bool = False   # sequence-parallel activations (beyond-paper opt)
    compress_grads: bool = False   # int8+error-feedback DP gradient compression
    ft_emu: str = ""               # "" | two_pass | fused — FlexHyCA cost emulation
    ft_s_th: float = 0.05          # important-neuron fraction for ft_emu
    # production layout policies adopted from the §Perf hillclimbs:
    tp_hint: int = 16              # preferred TP width on a 256-chip pod
    serve_replicated: bool = False # decode: TP-only weights (no FSDP psums)


def reduce_config(cfg: ModelConfig, **over) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw: dict = dict(
        name=cfg.name + "-reduced",
        n_layers=len(cfg.block_pattern) * 2 + len(cfg.tail),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
        window=16 if cfg.window else 0,
        n_enc_layers=2 if cfg.enc_dec else 0,
        n_frontend_tokens=8 if cfg.frontend else 0,
        rglru_width=64 if cfg.rglru_width else 0,
        unroll=True,
    )
    if cfg.moe:
        kw["moe"] = MoECfg(n_experts=4, top_k=2, d_ff=32,
                           capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm:
        kw["ssm"] = SSMCfg(d_state=16, expand=2, head_dim=16, chunk=8)
    kw.update(over)
    return dataclasses.replace(cfg, **kw)
