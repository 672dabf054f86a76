"""SCALE-Sim-like analytic performance / IO model of FlexHyCA.

Output-stationary systolic timing for the 2-D array; occupancy model for the
DPPU; DRAM IO accounting including the paper's two extra-IO sources for
TMR-CL: (1) direct DRAM loads when a tile's important-neuron fraction exceeds
DPPU capacity, and (2) important-neuron position tables.

Counterpart of ``repro.core.perfmodel``: a copy of its code, as the
reference's package imports JAX, which the port does not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One layer's MAC workload as an (M, K, N) GEMM (convs via im2col)."""
    name: str
    M: int
    K: int
    N: int
    sensitive: bool = False  # layer-level sensitivity (for ARCH/ALG TMR)

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N

    @property
    def weight_bytes(self) -> int:
        return self.K * self.N  # int8

    @property
    def act_bytes(self) -> int:
        return self.M * (self.K + self.N)


def gemm_cycles(g: Gemm, rows: int, cols: int) -> int:
    """Output-stationary pass: each (rows x cols) output tile needs K cycles of
    accumulation plus fill/drain ramps."""
    tiles = math.ceil(g.M / rows) * math.ceil(g.N / cols)
    return tiles * (g.K + rows + cols - 2)


@dataclasses.dataclass(frozen=True)
class DlaConfig:
    array_dim: int = 32
    dot_size: int = 0            # DPPU MAC count (0 = no DPPU)
    data_reuse: bool = True
    freq_ghz: float = 1.0


def base_exec_cycles(layers: Sequence[Gemm], cfg: DlaConfig) -> int:
    return sum(gemm_cycles(g, cfg.array_dim, cfg.array_dim) for g in layers)


def exec_cycles(layers: Sequence[Gemm], cfg: DlaConfig, strategy: str,
                s_th: float = 0.0, protect_sensitive_only: bool = True) -> int:
    """Execution time under a protection strategy.

    strategies: base | crt (circuit TMR, no timing change) | arch (spatial TMR
    => 1/3 the array for protected layers) | alg (temporal TMR => 3x time on
    protected layers) | cl (FlexHyCA: DPPU recompute overlaps the 2-D array;
    slowdown only when the DPPU is the bottleneck).
    """
    total = 0
    for g in layers:
        c = gemm_cycles(g, cfg.array_dim, cfg.array_dim)
        protected = g.sensitive or not protect_sensitive_only
        if strategy in ("base", "crt") or not protected:
            total += c
        elif strategy == "arch":
            # array divided into three voting replicas -> 1/3 the columns
            total += gemm_cycles(g, cfg.array_dim, max(cfg.array_dim // 3, 1))
        elif strategy == "alg":
            total += 3 * c
        elif strategy == "cl":
            dppu_macs_per_cycle = max(cfg.dot_size, 1)
            dppu_cycles = math.ceil(s_th * g.macs / dppu_macs_per_cycle)
            total += max(c, dppu_cycles)  # overlapped; DPPU rarely dominates
        else:
            raise ValueError(strategy)
    return total


def io_bytes(layers: Sequence[Gemm], cfg: DlaConfig, strategy: str,
             s_th: float = 0.0) -> dict:
    """DRAM traffic model.  Returns dict with base/extra/ratio-to-weights."""
    weights = sum(g.weight_bytes for g in layers)
    acts = sum(g.act_bytes for g in layers)
    extra = 0.0
    if strategy == "cl" and s_th > 0:
        for g in layers:
            # (2) position tables: 4B index per important neuron, streamed per
            # tile pass over the layer.
            n_imp = s_th * g.N
            tile_passes = math.ceil(g.M / cfg.array_dim)
            extra += 4.0 * n_imp * tile_passes
            # (1) DPPU direct loads: weight columns of important neurons are
            # re-read; with Data_reuse the activation rows come from the 2-D
            # array cache, otherwise they stream from DRAM too.
            extra += s_th * g.weight_bytes
            if not cfg.data_reuse:
                extra += s_th * g.M * g.K
    elif strategy == "alg":
        # temporal TMR re-reads weights+acts of protected layers twice more
        for g in layers:
            if g.sensitive:
                extra += 2.0 * (g.weight_bytes + g.act_bytes)
    return dict(weights=weights, acts=acts, extra=extra,
                extra_over_weights=extra / max(weights, 1))


def perf_loss(layers: Sequence[Gemm], cfg: DlaConfig, strategy: str,
              s_th: float = 0.0) -> float:
    """Relative execution-time increase vs the unprotected base design."""
    base = base_exec_cycles(layers, cfg)
    return exec_cycles(layers, cfg, strategy, s_th) / max(base, 1) - 1.0


def lm_layer_gemms(n_layers: int, d_model: int, d_ff: int, n_heads: int,
                   d_head: int, n_kv_heads: int, seq: int,
                   sensitive_frac: float = 0.4) -> list[Gemm]:
    """Build a per-layer GEMM workload for a transformer block (used to drive
    the DLA perf model with the assigned architectures' shapes)."""
    out = []
    q = n_heads * d_head
    kv = n_kv_heads * d_head
    n_sens = int(round(sensitive_frac * n_layers))
    for i in range(n_layers):
        s = i < n_sens  # early layers are the sensitive ones (cf. Fig. 5)
        out += [
            Gemm(f"l{i}.wq", seq, d_model, q, s),
            Gemm(f"l{i}.wkv", seq, d_model, 2 * kv, s),
            Gemm(f"l{i}.wo", seq, q, d_model, s),
            Gemm(f"l{i}.ffn_in", seq, d_model, d_ff, s),
            Gemm(f"l{i}.ffn_out", seq, d_ff, d_model, s),
        ]
    return out


# VGG16 at 224x224 as im2col GEMMs, the DSE's perf/IO workload: a copy of
# benchmarks/workloads.py, which imports the JAX package: (name, out_hw, k,
# cin, cout), then the three fc layers
_VGG16 = (
    ("conv1_1", 224, 3, 3, 64), ("conv1_2", 224, 3, 64, 64),
    ("conv2_1", 112, 3, 64, 128), ("conv2_2", 112, 3, 128, 128),
    ("conv3_1", 56, 3, 128, 256), ("conv3_2", 56, 3, 256, 256),
    ("conv3_3", 56, 3, 256, 256),
    ("conv4_1", 28, 3, 256, 512), ("conv4_2", 28, 3, 512, 512),
    ("conv4_3", 28, 3, 512, 512),
    ("conv5_1", 14, 3, 512, 512), ("conv5_2", 14, 3, 512, 512),
    ("conv5_3", 14, 3, 512, 512),
)


def vgg16_gemms() -> list[Gemm]:
    """VGG16's GEMMs; the first 40% of the layers are the fault-sensitive
    set (cf. Fig. 5)."""
    out = [(n, hw * hw, k * k * cin, cout) for n, hw, k, cin, cout in _VGG16]
    out += [("fc6", 1, 7 * 7 * 512, 4096), ("fc7", 1, 4096, 4096),
            ("fc8", 1, 4096, 1000)]
    n_sens = int(0.4 * len(out))
    return [Gemm(*g, sensitive=i < n_sens) for i, g in enumerate(out)]
