"""Algorithm 3 — Bayesian cross-layer design-space exploration.

GP (RBF kernel) surrogate + Expected Improvement over the discrete Table-I
space, minimizing redundant chip area subject to accuracy / performance /
bandwidth constraints, with the paper's monotonic pruning: protection
parameters (S_TH, IB_TH, NB_TH) are monotone in both accuracy and area, so a
constraint violation at v prunes every v' with component-wise weaker
protection.

With ``batch_size > 1`` each round proposes q candidates by q-EI with the
constant-liar heuristic (refit the surrogate pretending each picked point
already achieved the incumbent, so the next pick moves elsewhere) and hands
them to ``evaluate_batch`` in one call — the oracle amortizes its
fault-injection executables across the batch (see docs/dse.md).
``batch_size=1`` is the exact sequential Algorithm 3.  Dedup (``seen``) and
monotonic dominance pruning are applied per-candidate at selection time, so
a batch never contains duplicates or configs already known infeasible.

Counterpart of ``repro.core.bayesopt``: a copy of its code, as the
reference's package imports JAX, which the port does not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Param:
    name: str
    values: tuple
    # +1: increasing this param increases both accuracy and area (protection
    # strength); 0: no known monotonicity.
    monotone: int = 0


def table1_space() -> list[Param]:
    """The paper's Table I search space."""
    return [
        Param("s_th", tuple(x / 100 for x in range(5, 45, 5)), monotone=+1),
        Param("ib_th", (2, 3, 4), monotone=+1),
        Param("nb_th", (1, 2, 3), monotone=+1),
        Param("q_scale", tuple(range(1, 17)), monotone=0),
        Param("s_policy", ("uniform", "global"), monotone=0),
        Param("dot_size", (8, 16, 32, 52, 64, 128, 256), monotone=0),
        Param("data_reuse", (True, False), monotone=0),
        Param("pe_policy", ("direct", "configurable"), monotone=0),
    ]


def fat_table1_space(fat_bers: tuple = (0.0, 1e-3, 2e-3)) -> list[Param]:
    """Table I extended with the training-time axis: ``fat_ber`` selects how
    much fault pressure the network was *trained* through (fault-aware
    training).  A FAT-hardened network tolerates more deployment faults, so
    the DSE can trade protection hardware against training exposure.  Not
    marked monotone: higher fat_ber helps accuracy-under-fault but is not a
    protection-strength knob (it costs nothing in area)."""
    return table1_space() + [Param("fat_ber", tuple(fat_bers), monotone=0)]


@dataclasses.dataclass
class EvalResult:
    area: float          # redundant-area overhead (objective, minimized)
    acc: float           # accuracy under fault injection
    perf_loss: float
    bw_loss: float

    def feasible(self, c: "Constraints") -> bool:
        return (self.acc >= c.acc_min and self.perf_loss <= c.perf_max
                and self.bw_loss <= c.bw_max)


@dataclasses.dataclass(frozen=True)
class Constraints:
    acc_min: float
    perf_max: float = 0.10
    bw_max: float = 0.10


class _GP:
    """Minimal GP regressor (RBF + noise), numpy/cholesky."""

    def __init__(self, ls: float = 0.35, noise: float = 1e-4):
        self.ls, self.noise = ls, noise
        self.X = self.y = self.L = self.alpha = None
        self.mu0 = 0.0

    def _k(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.ls ** 2)

    def fit(self, X: np.ndarray, y: np.ndarray):
        self.X = X
        self.mu0 = float(y.mean())
        self.y = y - self.mu0
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(self.L.T, np.linalg.solve(self.L, self.y))

    def posterior(self, Xs: np.ndarray):
        Ks = self._k(Xs, self.X)
        mu = Ks @ self.alpha + self.mu0
        v = np.linalg.solve(self.L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        return mu, var


def _ei(mu, var, best):
    """Expected improvement for minimization."""
    sd = np.sqrt(var)
    z = (best - mu) / sd
    cdf = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
    pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    return (best - mu) * cdf + sd * pdf


@dataclasses.dataclass
class DseResult:
    best: dict | None
    best_eval: EvalResult | None
    history: list          # (config, EvalResult) — every oracle call
    pruned: int            # configs skipped by monotonic pruning
    evaluations: int


def bayes_design_opt(space: Sequence[Param],
                     evaluate: Callable[[Mapping], EvalResult] | None,
                     constraints: Constraints,
                     iter_max_step: int = 64,
                     n_init: int = 12,
                     n_candidates: int = 256,
                     seed: int = 0,
                     prune_margin: float = 0.02,
                     batch_size: int = 1,
                     evaluate_batch: Callable[[list], list] | None = None,
                     ) -> DseResult:
    """Algorithm 3: Bayesian DSE with monotonic constraint pruning.

    prune_margin: accuracy oracles are stochastic (fault-injection draws), so
    a point only enters the dominance-pruning record when it misses the
    accuracy bar by more than the margin — otherwise one unlucky draw on a
    strongly-protected config would prune the entire space below it.

    batch_size: candidates proposed (and evaluated) per BO round.  1 keeps
    the exact sequential behavior; q > 1 selects by constant-liar q-EI and
    calls ``evaluate_batch`` with up to q configs at once.

    evaluate_batch: ``list[cfg dict] -> list[EvalResult]``, positionally
    aligned.  Defaults to mapping ``evaluate`` over the batch; required when
    ``evaluate`` is None."""
    if evaluate is None and evaluate_batch is None:
        raise ValueError("need evaluate or evaluate_batch")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")

    def eval_many(cfgs: list[dict]) -> list[EvalResult]:
        if evaluate_batch is not None and (len(cfgs) > 1 or evaluate is None):
            return list(evaluate_batch(cfgs))
        return [evaluate(c) for c in cfgs]

    rng = np.random.default_rng(seed)
    names = [p.name for p in space]
    mono = np.array([p.monotone for p in space])

    def sample() -> tuple:
        return tuple(p.values[rng.integers(len(p.values))] for p in space)

    def to_unit(v: tuple) -> np.ndarray:
        out = []
        for p, x in zip(space, v):
            i = p.values.index(x)
            out.append(i / max(len(p.values) - 1, 1))
        return np.array(out)

    # pruning record: unit-space protection coordinates of infeasible points
    infeasible_protection: list[np.ndarray] = []
    mono_idx = np.nonzero(mono > 0)[0]

    def pruned_by_dominance(u: np.ndarray) -> bool:
        if not len(mono_idx):
            return False
        for f in infeasible_protection:
            if np.all(u[mono_idx] <= f[mono_idx] + 1e-12):
                return True
        return False

    seen: set[tuple] = set()
    X, y, history = [], [], []
    pruned = 0
    best_eval: EvalResult | None = None
    best_cfg = None
    penalty = 10.0

    def commit(v: tuple, u: np.ndarray, r: EvalResult):
        """Record one oracle result: surrogate data, pruning record, best."""
        nonlocal best_eval, best_cfg
        cfg = dict(zip(names, v))
        history.append((cfg, r))
        feas = r.feasible(constraints)
        score = r.area if feas else r.area + penalty * (
            max(constraints.acc_min - r.acc, 0) * 10
            + max(r.perf_loss - constraints.perf_max, 0)
            + max(r.bw_loss - constraints.bw_max, 0))
        X.append(u)
        y.append(score)
        if not feas and r.acc < constraints.acc_min - prune_margin:
            infeasible_protection.append(u)  # weaker protection also fails
        if feas and (best_eval is None or r.area < best_eval.area):
            best_eval, best_cfg = r, cfg

    def run_batch(batch: list[tuple[tuple, np.ndarray]]):
        if not batch:
            return
        results = eval_many([dict(zip(names, v)) for v, _ in batch])
        for (v, u), r in zip(batch, results):
            commit(v, u, r)

    def admit(v: tuple) -> np.ndarray | None:
        """Dedup + dominance gate, applied per candidate before batching."""
        nonlocal pruned
        if v in seen:
            return None
        u = to_unit(v)
        if pruned_by_dominance(u):
            pruned += 1
            return None
        seen.add(v)
        return u

    # ---- init: random configs, evaluated in batch_size chunks ------------
    pending: list[tuple[tuple, np.ndarray]] = []
    for _ in range(n_init):
        v = sample()
        u = admit(v)
        if u is not None:
            pending.append((v, u))
        if len(pending) >= batch_size:
            run_batch(pending)
            pending = []
    run_batch(pending)

    gp = _GP()
    step = len(history)
    while step < iter_max_step:
        if len(X) < 2:
            v = sample()
            u = admit(v)
            if u is not None:
                run_batch([(v, u)])
            step += 1  # legacy accounting: a dud sample still burns a step
            continue
        q = min(batch_size, iter_max_step - step)
        cands = [sample() for _ in range(n_candidates)]
        cands = [c for c in cands if c not in seen]
        if not cands:
            break
        U = np.stack([to_unit(c) for c in cands])
        gp.fit(np.stack(X), np.array(y))
        # constant-liar q-EI: after each pick, refit pretending the pick
        # already achieved the incumbent, so EI moves the next pick elsewhere
        Xv, yv = list(X), list(y)
        taken: set[int] = set()
        counted: set[int] = set()   # dominated candidates counted this round
        batch: list[tuple[tuple, np.ndarray]] = []
        for j in range(q):
            if j > 0:
                gp.fit(np.stack(Xv), np.array(yv))
            mu, var = gp.posterior(U)
            ei = _ei(mu, var, min(yv))
            sel = None
            for i in np.argsort(-ei):
                if i in taken or cands[i] in seen:
                    # `seen` catches duplicate tuples sampled at two indices
                    continue
                if pruned_by_dominance(U[i]):
                    if i not in counted:
                        counted.add(i)
                        pruned += 1
                    continue
                sel = int(i)
                break
            if sel is None:
                break
            taken.add(sel)
            seen.add(cands[sel])
            batch.append((cands[sel], U[sel]))
            Xv.append(U[sel])
            yv.append(min(yv))  # the lie: assume the incumbent value
        if not batch:
            break
        run_batch(batch)
        step += len(batch)

    return DseResult(best=best_cfg, best_eval=best_eval, history=history,
                     pruned=pruned, evaluations=len(history))
