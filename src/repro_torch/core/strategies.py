"""The paper's comparison set of fault-tolerant DLA designs.

Base, TMR-CRT{1,2,3}, TMR-ARCH, TMR-ALG, TMR-CL — each a
:class:`repro_torch.ft.ProtectionPolicy` from the policy registry, exposing
the three evaluation axes of Section IV: accuracy-under-fault (via
``ft.protect_linear``), execution time (via ``perfmodel``) and redundant
chip area (via ``area``).  All per-design behavior is derived from the policy's
layer structure; there are no name->behavior tables here.

Counterpart of ``repro.core.strategies``: a copy of its code, as the
reference's package imports JAX, which the port does not.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import area as A
from repro_torch.core import perfmodel as P
from repro_torch.ft import ProtectionPolicy, as_policy, paper_policies


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str
    policy: ProtectionPolicy

    @property
    def ft(self) -> ProtectionPolicy:  # legacy field name
        return self.policy

    def with_ber(self, ber: float) -> ProtectionPolicy:
        return self.policy.with_ber(ber)

    def _dla(self, array_dim: int) -> P.DlaConfig:
        arch = self.policy.arch
        return P.DlaConfig(array_dim=array_dim, dot_size=arch.dot_size,
                           data_reuse=arch.data_reuse)

    # ---- area -----------------------------------------------------------
    def area_relative(self, array_dim: int = 32) -> float:
        """Computing-array area relative to the unprotected base array."""
        p = self.policy
        kind = p.perf_kind
        if kind == "base":
            return 1.0
        if kind == "crt":
            # circuit-only: every PE protects its top-nb_th bits.
            return (A.protected_pe_cost(p.circuit.nb_th,
                                        q_scale=p.algorithm.q_scale,
                                        policy=p.circuit.pe_policy)
                    / A.pe_cost())
        if kind == "arch":
            # spatial TMR: voting logic + control on the existing array
            return 1.0 + (A.GE_VOTER * A.OUT_BITS * 3) / (A.pe_cost() * 9)
        if kind == "alg":
            return 1.0  # temporal redundancy: no extra hardware
        # cross-layer: selectively hardened array + DPPU
        r = A.array_area(array_dim, p.circuit.nb_th, p.algorithm.q_scale,
                         p.circuit.pe_policy, dot_size=p.arch.dot_size,
                         ib_th=p.circuit.ib_th)
        return r["relative"]

    # ---- performance ------------------------------------------------------
    def perf_loss(self, layers: Sequence[P.Gemm], array_dim: int = 32) -> float:
        return P.perf_loss(layers, self._dla(array_dim), self.policy.perf_kind,
                           s_th=self.policy.algorithm.s_th)

    def extra_io(self, layers: Sequence[P.Gemm], array_dim: int = 32) -> float:
        io = P.io_bytes(layers, self._dla(array_dim), self.policy.perf_kind,
                        s_th=self.policy.algorithm.s_th)
        return io["extra_over_weights"]


def make_strategies(cl=None) -> dict[str, Strategy]:
    """The paper's comparison set.  `cl` is the DSE-optimized TMR-CL design
    (a ProtectionPolicy, a legacy FTConfig, or None for the registry
    default)."""
    pols = paper_policies(as_policy(cl))
    return {name: Strategy(name, p) for name, p in pols.items()}
