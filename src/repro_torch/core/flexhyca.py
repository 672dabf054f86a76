"""FlexHyCA: the legacy entry point of the heterogeneous fault-tolerant DLA.

Counterpart of ``repro.core.flexhyca``.  The protection math lives in
:mod:`repro_torch.ft` (``protect_linear`` with the policy registry); this
module keeps the original surface:

  * :class:`FTConfig`: the flat Table-I design vector of experiment
    configs; convert with ``repro_torch.ft.from_ftconfig``;
  * :func:`ft_linear`: deprecation shim over ``protect_linear`` (reference
    backend);
  * :func:`clean_linear`: the fault-free quantized reference.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.core import quantization as Q


@dataclasses.dataclass(frozen=True)
class FTConfig:
    """Cross-layer fault-tolerance configuration (paper Table I vector V).

    ``strategy`` names a design in the ``repro_torch.ft`` policy registry;
    the seven paper designs are ``base | crt1 | crt2 | crt3 | arch | alg |
    cl``.
    """
    ber: float = 0.0          # bit error rate of the substrate
    s_th: float = 0.05        # fraction of important neurons
    ib_th: int = 2            # protected high bits of important neurons (DPPU)
    nb_th: int = 1            # protected high bits of ordinary neurons (2-D array)
    q_scale: int = 7          # quantization truncation constraint
    s_policy: str = "uniform"
    dot_size: int = 52
    data_reuse: bool = True
    pe_policy: str = "configurable"
    strategy: str = "cl"
    weight_faults: bool = True
    seed: int = 0


def ft_linear(key, x: torch.Tensor, w: torch.Tensor, cfg: FTConfig,
              important=None, layer_protected: bool = True) -> torch.Tensor:
    """Deprecated shim: use ``repro_torch.ft.protect_linear`` with a
    registry policy.  Same result as the reference backend."""
    from repro_torch import ft
    warnings.warn(
        "repro_torch.core.flexhyca.ft_linear is deprecated; use "
        "repro_torch.ft.protect_linear(key, x, w, ft.get_policy(name, ...))",
        DeprecationWarning, stacklevel=2)
    return ft.protect_linear(key, x, w, ft.from_ftconfig(cfg),
                             important=important,
                             layer_protected=layer_protected)


def clean_linear(x: torch.Tensor, w: torch.Tensor,
                 q_scale: int = 0) -> torch.Tensor:
    """Fault-free quantized reference (for accuracy-delta measurements)."""
    y, _ = Q.fake_quant_linear(x.reshape(-1, x.shape[-1]), w, q_scale=q_scale)
    return y.reshape(*x.shape[:-1], w.shape[1])
