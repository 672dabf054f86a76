"""Algorithm 2 — bit-importance evaluation.

Enumerates (IB_TH, NB_TH) combinations for a fixed important-neuron set,
scoring each with a fault-injection accuracy oracle and the circuit-level
protection cost table, and returns the cheapest setting meeting the accuracy
objective.  Mirrors the paper: high bits are always protected first, NB <= IB.

Counterpart of ``repro.core.bit_importance``: a copy of its code, as the
reference's package imports JAX, which the port does not.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import area as A


@dataclasses.dataclass(frozen=True)
class BitConfig:
    ib_th: int
    nb_th: int
    acc: float
    cost: float


def protection_cost_table(bits: int = 8, q_scale: int = 0,
                          policy: str = "configurable",
                          array_dim: int = 32, dot_size: int = 52,
                          s_th: float = 0.05) -> dict[tuple[int, int], float]:
    """Pre-evaluated area cost for every (ib, nb) — the paper pre-builds this
    table so the DSE only does lookups."""
    table = {}
    for ib in range(0, bits + 1):
        for nb in range(0, ib + 1):
            r = A.array_area(array_dim, nb, q_scale, policy,
                             dot_size=dot_size, ib_th=ib)
            table[(ib, nb)] = r["overhead"]
    return table


def get_bit_config(acc_oracle: Callable[[int, int], float],
                   acc_target: float,
                   bits: int = 8,
                   cost_table: dict[tuple[int, int], float] | None = None,
                   **table_kw) -> BitConfig | None:
    """Algorithm 2.  acc_oracle(ib, nb) -> accuracy under fault injection.

    Monotonicity pruning: accuracy is monotone non-decreasing in (ib, nb), so
    if (ib, nb) fails the target, every (ib' <= ib, nb' <= nb) also fails and
    is skipped without running the oracle.
    """
    table = cost_table or protection_cost_table(bits, **table_kw)
    failed: list[tuple[int, int]] = []
    best: BitConfig | None = None
    for ib in range(1, bits + 1):
        for nb in range(0, ib + 1):
            if any(ib <= fi and nb <= fn for fi, fn in failed):
                continue  # pruned (dominated by a known failure)
            cost = table[(ib, nb)]
            if best is not None and cost >= best.cost:
                continue  # cannot improve
            acc = acc_oracle(ib, nb)
            if acc >= acc_target:
                if best is None or cost < best.cost:
                    best = BitConfig(ib, nb, acc, cost)
            else:
                failed.append((ib, nb))
    return best
