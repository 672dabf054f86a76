"""Normalising the ways a caller names a protection policy, and bridging
the legacy ``FTConfig`` vector onto protection policies.

Counterpart of ``repro.ft.compat``.  ``FTConfig`` remains the flat Table-I
design vector of older experiment configs
(``repro_torch.core.flexhyca.FTConfig``); everything downstream of the
public API speaks :class:`~repro_torch.ft.policy.ProtectionPolicy`.
"""
from __future__ import annotations

from repro_torch.ft.policy import ProtectionPolicy
from repro_torch.ft.registry import get_policy


def from_ftconfig(cfg) -> ProtectionPolicy:
    """Convert a legacy ``FTConfig`` (duck-typed: any object with its
    fields) into the equivalent registered policy.

    Only the fields the named design consumes are carried over: e.g. a
    ``crt2`` config's ``q_scale``/``ib_th`` were always inert (the
    protected-bit count comes from the design name), and remain so.
    """
    base = get_policy(cfg.strategy)
    over = dict(ber=cfg.ber, weight_faults=cfg.weight_faults, seed=cfg.seed,
                dot_size=cfg.dot_size, data_reuse=cfg.data_reuse)
    if base.uses_importance:  # the cross-layer design: full tunable surface
        over.update(s_th=cfg.s_th, s_policy=cfg.s_policy, q_scale=cfg.q_scale,
                    ib_th=cfg.ib_th, nb_th=cfg.nb_th, pe_policy=cfg.pe_policy)
    return base.tune(**over)


def as_policy(ft) -> ProtectionPolicy | None:
    """Normalize None | policy name | FTConfig | ProtectionPolicy."""
    if ft is None or isinstance(ft, ProtectionPolicy):
        return ft
    if isinstance(ft, str):
        return get_policy(ft)
    return from_ftconfig(ft)
