"""String-keyed protection-policy registry.

All seven comparison designs of the paper (Sec. IV) are registered here at
import time; a new design plugs in with one ``register_policy`` call.

Counterpart of ``repro.ft.registry``: the same seven designs.
"""
from __future__ import annotations

from repro_torch.ft.policy import (AlgorithmLayer, ArchLayer, CircuitLayer,
                             ProtectionPolicy)

_REGISTRY: dict[str, ProtectionPolicy] = {}


def register_policy(policy: ProtectionPolicy) -> ProtectionPolicy:
    """Register ``policy`` under ``policy.name``."""
    key = policy.name
    if not key:
        raise ValueError("policy needs a non-empty name to be registered")
    if key in _REGISTRY:
        raise ValueError(f"policy {key!r} already registered")
    _REGISTRY[key] = policy
    return policy


def get_policy(name: str, **tune) -> ProtectionPolicy:
    """Look up a registered policy; keyword overrides are routed through
    :meth:`ProtectionPolicy.tune` (e.g. ``get_policy("cl", ber=1e-3,
    ib_th=4)``)."""
    try:
        policy = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown protection policy {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None
    return policy.tune(**tune) if tune else policy


def _register_paper_designs() -> None:
    # Unprotected baseline: plain quantized datapath, no redundancy anywhere.
    register_policy(ProtectionPolicy(
        name="base",
        algorithm=AlgorithmLayer(q_scale=0),
        circuit=CircuitLayer(ib_th=0, nb_th=0)))
    # Circuit-only TMR: every PE protects its top-k output bits, importance-
    # blind (ib == nb), direct (non-configurable) protection wiring.
    for k in (1, 2, 3):
        register_policy(ProtectionPolicy(
            name=f"crt{k}",
            algorithm=AlgorithmLayer(q_scale=0),
            circuit=CircuitLayer(ib_th=k, nb_th=k, pe_policy="direct")))
    # Architecture-only: spatial TMR of the sensitive layers (array split in
    # three voting replicas).
    register_policy(ProtectionPolicy(
        name="arch",
        algorithm=AlgorithmLayer(q_scale=0),
        arch=ArchLayer(whole_layer_tmr=True, temporal=False)))
    # Algorithm-only: temporal TMR of the sensitive layers (3x re-execution).
    register_policy(ProtectionPolicy(
        name="alg",
        algorithm=AlgorithmLayer(q_scale=0),
        arch=ArchLayer(whole_layer_tmr=True, temporal=True)))
    # The paper's cross-layer design: importance-driven DPPU recompute +
    # selective high-bit TMR + Q_scale-constrained quantization.
    register_policy(ProtectionPolicy(
        name="cl",
        algorithm=AlgorithmLayer(s_th=0.05, s_policy="uniform", q_scale=7),
        arch=ArchLayer(recompute=True),
        circuit=CircuitLayer(ib_th=2, nb_th=1, pe_policy="configurable")))


_register_paper_designs()
