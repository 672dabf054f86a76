"""End-to-end cross-layer optimization entry point (paper Fig. 1).

Wires Algorithm 1 (neuron importance) + Algorithm 2 (bit importance) + the
area/perf/IO oracles + Algorithm 3 (Bayesian DSE) into one call:

    result = optimize(model_eval, workload, constraints, fault_rate)

``model_eval`` is an accuracy oracle: ProtectionPolicy -> accuracy-under-
fault.  It is supplied by the benchmark harness (CNN or LM evaluation with
``repro_torch.ft.protect_linear``).

With ``batch_size > 1`` the DSE proposes q candidates per round
(constant-liar q-EI, see ``repro_torch.core.bayesopt``) and evaluates them
in one shot: the accuracy oracle via ``acc_oracle_batch`` (e.g.
``CnnOracle.accuracy_batch``, which runs the candidates' fault draws in one
call) and the analytic area/perf/IO oracles via the numpy-broadcast batch
evaluators below.  End-to-end usage and when q-EI helps: docs/dse.md.

Counterpart of ``repro.core.pipeline``: a copy of its code, as the
reference's package imports JAX, which the port does not.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import area as A
from repro_torch.core import bayesopt as B
from repro_torch.core import perfmodel as P
from repro_torch.ft import ProtectionPolicy, get_policy


@dataclasses.dataclass
class CrossLayerResult:
    policy: ProtectionPolicy | None
    dse: B.DseResult
    area_overhead: float | None

    @property
    def ft(self) -> ProtectionPolicy | None:  # legacy field name
        return self.policy


# DSE axes that configure *training*, not the deployed protection policy.
# They are stripped before policy construction (a policy pytree must not
# carry training metadata) and routed to the accuracy oracle instead, which
# uses them to pick the fault-aware-trained network that evaluates the
# candidate (see repro_torch.core.evaluate.FatCnnOracle).
TRAIN_AXES = ("fat_ber",)


def _policy_from_cfg(cfg: dict, ber: float) -> ProtectionPolicy:
    """One DSE point (a Table-I assignment dict) as a cross-layer policy."""
    cfg = {k: v for k, v in cfg.items() if k not in TRAIN_AXES}
    return get_policy("cl", ber=ber, **cfg)


# ------------------------------------------------------------------------
# Batched analytic oracles: one numpy-broadcast pass over (batch, layers)
# instead of per-config Python loops.  Bit-for-bit equal to the scalar
# area/perf/IO models (ceil arithmetic mirrors math.ceil on ints/floats).
# ------------------------------------------------------------------------
_pe_cost_v = np.vectorize(A.protected_pe_cost, otypes=[np.float64])


def batch_area_overhead(policies: Sequence[ProtectionPolicy],
                        array_dim: int) -> np.ndarray:
    """(B,) redundant-area overheads, broadcast over the candidate axis."""
    nb = np.array([p.circuit.nb_th for p in policies])
    ib = np.array([p.circuit.ib_th for p in policies])
    qs = np.array([p.algorithm.q_scale for p in policies])
    pe = np.array([p.circuit.pe_policy for p in policies], dtype=object)
    dot = np.array([p.arch.dot_size for p in policies])
    base = array_dim * array_dim * A.pe_cost()
    arr = array_dim * array_dim * _pe_cost_v(nb, qs, pe)
    dppu = dot * _pe_cost_v(ib, qs, pe) + dot * A.GE_FA * 2 + 64 * A.GE_FF
    return (arr + dppu - base) / base


def _gemm_arrays(layers: Sequence[P.Gemm]):
    M = np.array([g.M for g in layers], np.int64)
    K = np.array([g.K for g in layers], np.int64)
    N = np.array([g.N for g in layers], np.int64)
    sens = np.array([g.sensitive for g in layers], bool)
    return M, K, N, sens


def batch_perf_bw(policies: Sequence[ProtectionPolicy],
                  layers: Sequence[P.Gemm],
                  array_dim: int) -> tuple[np.ndarray, np.ndarray]:
    """(B,) perf_loss and (B,) extra-IO-over-weights for a candidate batch.

    Broadcasts the output-stationary cycle model and the DRAM IO model over
    a (batch, layers) grid; candidates are grouped by ``perf_kind`` since the
    kind switches the timing formula, not just its constants.
    """
    M, K, N, sens = _gemm_arrays(layers)
    dim = array_dim
    tiles = -(-M // dim) * (-(-N // dim))          # ceil-div, exact on ints
    cyc = tiles * (K + 2 * dim - 2)                # gemm_cycles(g, dim, dim)
    base = max(int(cyc.sum()), 1)
    macs = M * K * N
    wbytes = K * N
    abytes = M * (K + N)
    weights = max(int(wbytes.sum()), 1)

    perf = np.zeros(len(policies))
    bw = np.zeros(len(policies))
    kinds: dict[str, list[int]] = {}
    for i, p in enumerate(policies):
        kinds.setdefault(p.perf_kind, []).append(i)

    for kind, idxs in kinds.items():
        grp = [policies[i] for i in idxs]
        if kind == "cl":
            s_th = np.array([p.algorithm.s_th for p in grp])[:, None]
            dot = np.maximum(
                np.array([p.arch.dot_size for p in grp]), 1)[:, None]
            reuse = np.array([p.arch.data_reuse for p in grp])[:, None]
            dppu = np.ceil(s_th * macs[None, :] / dot)
            # DPPU overlap applies to the protected (sensitive) layers only
            total = np.where(sens[None, :],
                             np.maximum(cyc[None, :], dppu),
                             cyc[None, :]).sum(1)
            extra = (4.0 * s_th * N[None, :] * (-(-M // dim))[None, :]
                     + s_th * wbytes[None, :]
                     + np.where(reuse, 0.0, s_th * (M * K)[None, :]))
            extra = np.where(s_th > 0, extra, 0.0).sum(1)
        elif kind == "arch":
            cols = max(dim // 3, 1)
            tiles3 = -(-M // dim) * (-(-N // cols))
            cyc3 = tiles3 * (K + dim + cols - 2)
            total = np.where(sens, cyc3, cyc).sum() * np.ones(len(grp))
            extra = np.zeros(len(grp))
        elif kind == "alg":
            total = np.where(sens, 3 * cyc, cyc).sum() * np.ones(len(grp))
            extra = ((wbytes + abytes)[sens].sum() * 2.0
                     * np.ones(len(grp)))
        else:  # base / crt: no timing or IO change
            total = float(cyc.sum()) * np.ones(len(grp))
            extra = np.zeros(len(grp))
        perf[idxs] = total / base - 1.0
        bw[idxs] = extra / weights
    return perf, bw


def evaluate_policies(policies: Sequence[ProtectionPolicy],
                      accs: Sequence[float],
                      layers: Sequence[P.Gemm],
                      array_dim: int) -> list[B.EvalResult]:
    """Assemble EvalResults from batched accuracy + analytic oracles."""
    areas = batch_area_overhead(policies, array_dim)
    perfs, bws = batch_perf_bw(policies, layers, array_dim)
    return [B.EvalResult(area=float(a), acc=float(ac), perf_loss=float(p),
                         bw_loss=float(b))
            for a, ac, p, b in zip(areas, accs, perfs, bws)]


def optimize(acc_oracle: Callable[[ProtectionPolicy], float],
             layers: Sequence[P.Gemm],
             constraints: B.Constraints,
             ber: float,
             array_dim: int = 32,
             iter_max_step: int = 48,
             seed: int = 0,
             space: Sequence[B.Param] | None = None,
             batch_size: int = 1,
             acc_oracle_batch: Callable[[list], Sequence[float]] | None = None,
             ) -> CrossLayerResult:
    """Run the full cross-layer DSE for one fault-rate scenario.

    batch_size: DSE candidates proposed and evaluated per BO round; 1 is the
    sequential paper algorithm.
    acc_oracle_batch: ``list[ProtectionPolicy] -> accuracies`` evaluated in
    one shot (e.g. ``CnnOracle.accuracy_batch``); falls back to mapping
    ``acc_oracle`` when omitted.
    """
    space = space or B.table1_space()

    def evaluate(cfg: dict) -> B.EvalResult:
        policy = _policy_from_cfg(cfg, ber)
        alg, arch, circ = policy.algorithm, policy.arch, policy.circuit
        if "fat_ber" in cfg:
            acc = acc_oracle(policy, fat_ber=cfg["fat_ber"])
        else:
            acc = acc_oracle(policy)
        area = A.array_area(array_dim, circ.nb_th, alg.q_scale, circ.pe_policy,
                            dot_size=arch.dot_size,
                            ib_th=circ.ib_th)["overhead"]
        dla = P.DlaConfig(array_dim=array_dim, dot_size=arch.dot_size,
                          data_reuse=arch.data_reuse)
        perf = P.perf_loss(layers, dla, policy.perf_kind, s_th=alg.s_th)
        bw = P.io_bytes(layers, dla, policy.perf_kind,
                        s_th=alg.s_th)["extra_over_weights"]
        return B.EvalResult(area=area, acc=acc, perf_loss=perf, bw_loss=bw)

    def evaluate_batch(cfgs: list[dict]) -> list[B.EvalResult]:
        pols = [_policy_from_cfg(c, ber) for c in cfgs]
        fat = [c.get("fat_ber", 0.0) for c in cfgs] if any(
            "fat_ber" in c for c in cfgs) else None
        if acc_oracle_batch is not None:
            accs = list(acc_oracle_batch(pols) if fat is None
                        else acc_oracle_batch(pols, fat_bers=fat))
        elif fat is not None:
            accs = [acc_oracle(p, fat_ber=fb) for p, fb in zip(pols, fat)]
        else:
            accs = [acc_oracle(p) for p in pols]
        return evaluate_policies(pols, accs, layers, array_dim)

    dse = B.bayes_design_opt(space, evaluate, constraints,
                             iter_max_step=iter_max_step, seed=seed,
                             batch_size=batch_size,
                             evaluate_batch=evaluate_batch)
    policy = _policy_from_cfg(dse.best, ber) if dse.best else None
    return CrossLayerResult(
        policy=policy, dse=dse,
        area_overhead=dse.best_eval.area if dse.best_eval else None)
