"""Normalising the ways a caller names a protection policy.

Counterpart of ``repro.ft.compat::as_policy``.  The legacy ``FTConfig``
vector (``from_ftconfig``) is not ported yet.
"""
from __future__ import annotations

from repro_torch.ft.policy import ProtectionPolicy
from repro_torch.ft.registry import get_policy


def as_policy(ft) -> ProtectionPolicy | None:
    """Normalize None | registry name | ProtectionPolicy."""
    if ft is None or isinstance(ft, ProtectionPolicy):
        return ft
    if isinstance(ft, str):
        return get_policy(ft)
    raise TypeError(f"cannot make a protection policy of {type(ft).__name__};"
                    " the legacy FTConfig shim is not ported")
