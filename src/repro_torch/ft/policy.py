"""Protection policies: the cross-layer fault-tolerance vocabulary.

A ``ProtectionPolicy`` bundles the paper's three layers into one object:

  * :class:`AlgorithmLayer`  — importance selection (Algorithm 1) and the
    Q_scale quantization constraint,
  * :class:`ArchLayer`       — DPPU recompute-and-select and whole-layer
    spatial/temporal TMR, plus the DPPU/dataflow knobs the perf model reads,
  * :class:`CircuitLayer`    — per-channel high-bit TMR (IB_TH / NB_TH) and
    the PE protection wiring policy.

Counterpart of ``repro.ft.policy``.  Policies are frozen dataclasses;
``ber`` is the one value that varies (the reference registers it as the
policy pytree's only leaf).  ``protect_linear`` hands it to the fault draws
as a float32 scalar, as the reference's jitted datapath sees it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlgorithmLayer:
    """Algorithm-layer knobs (paper Sec. III-A): neuron-importance selection
    and the quantization (Q_scale) constraint on the accumulator window."""
    s_th: float = 0.05        # fraction of output channels deemed important
    s_policy: str = "uniform"  # importance selection policy (Algorithm 1)
    q_scale: int = 0          # minimum truncation LSB; 0 = unconstrained


@dataclasses.dataclass(frozen=True)
class ArchLayer:
    """Architecture-layer knobs (paper Sec. III-B): how redundancy is laid
    out across the compute fabric."""
    recompute: bool = False        # DPPU recompute-and-select (FlexHyCA)
    whole_layer_tmr: bool = False  # full-layer TMR of protected layers
    temporal: bool = False         # TMR in time (ALG) vs space (ARCH)
    dot_size: int = 52             # DPPU MAC count
    data_reuse: bool = True        # DPPU reads activations from the array cache


@dataclasses.dataclass(frozen=True)
class CircuitLayer:
    """Circuit-layer knobs (paper Sec. III-D): per-channel high-bit TMR."""
    ib_th: int = 0            # protected high bits of important channels
    nb_th: int = 0            # protected high bits of ordinary channels
    pe_policy: str = "configurable"  # PE protection wiring: configurable|direct


# Fields routed by ProtectionPolicy.tune() to each component.
_ALG_FIELDS = frozenset(f.name for f in dataclasses.fields(AlgorithmLayer))
_ARCH_FIELDS = frozenset(f.name for f in dataclasses.fields(ArchLayer))
_CIRCUIT_FIELDS = frozenset(f.name for f in dataclasses.fields(CircuitLayer))


@dataclasses.dataclass(frozen=True)
class ProtectionPolicy:
    """One complete cross-layer protection design.

    ``ber`` is the only value that varies; all other fields are structure
    the compute path dispatches on.
    """
    name: str
    algorithm: AlgorithmLayer = AlgorithmLayer()
    arch: ArchLayer = ArchLayer()
    circuit: CircuitLayer = CircuitLayer()
    ber: float = 0.0
    weight_faults: bool = True
    seed: int = 0

    @property
    def uses_importance(self) -> bool:
        """Whether this policy consumes Algorithm-1 importance masks."""
        return self.arch.recompute

    # -------------------------------------------------------- derivation --
    @property
    def perf_kind(self) -> str:
        """The perf/IO-model family this policy belongs to, derived from the
        layer structure."""
        if self.arch.whole_layer_tmr:
            return "alg" if self.arch.temporal else "arch"
        if self.arch.recompute:
            return "cl"
        if self.circuit.ib_th > 0 or self.circuit.nb_th > 0:
            return "crt"
        return "base"

    # ------------------------------------------------------------- tuning --
    def tune(self, **overrides) -> "ProtectionPolicy":
        """Return a copy with fields replaced, routing each name to the
        component that owns it (``ib_th`` -> circuit, ``s_th`` -> algorithm,
        ``dot_size`` -> arch, ``ber``/``weight_faults``/``seed``/``name`` ->
        the policy itself)."""
        alg, arch, circ, top = {}, {}, {}, {}
        for k, v in overrides.items():
            if k in _ALG_FIELDS:
                alg[k] = v
            elif k in _ARCH_FIELDS:
                arch[k] = v
            elif k in _CIRCUIT_FIELDS:
                circ[k] = v
            elif k in ("ber", "weight_faults", "seed", "name"):
                top[k] = v
            else:
                raise TypeError(f"unknown protection-policy field: {k!r}")
        if alg:
            top["algorithm"] = dataclasses.replace(self.algorithm, **alg)
        if arch:
            top["arch"] = dataclasses.replace(self.arch, **arch)
        if circ:
            top["circuit"] = dataclasses.replace(self.circuit, **circ)
        return dataclasses.replace(self, **top)

    def with_ber(self, ber) -> "ProtectionPolicy":
        """Copy with a new BER (a float or a 0-d float32 tensor)."""
        return dataclasses.replace(self, ber=ber)

