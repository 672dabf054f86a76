"""The paper path's numpy modules in the port equal the reference's.

``repro_torch.core.{area, perfmodel, bayesopt, bit_importance, strategies,
pipeline}`` are copies of the reference's modules (whose package imports
JAX), and ``repro_torch.ft`` carries the registry's paper set, ``perf_kind``
and the legacy ``FTConfig`` shim.  Every case is one of the reference's own
tests (tests/test_area.py, test_perfmodel.py, test_bayesopt.py,
test_bit_importance.py, test_batched_dse.py's synthetic DSE runs,
test_flexhyca.py, test_quantization.py), run through both packages on the
same inputs.  Tolerance: none (equal outputs) for everything but
``quant_error``, a float RMS over a reduction whose order is each
framework's own (stated below).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ft as jft
from repro.core import area as JA
from repro.core import bayesopt as JB
from repro.core import bit_importance as JBI
from repro.core import flexhyca as JF
from repro.core import perfmodel as JP
from repro.core import pipeline as JPL
from repro.core import quantization as JQ
from repro.core import strategies as JS
from repro_torch import ft as tft
from repro_torch.core import area as TA
from repro_torch.core import bayesopt as TB
from repro_torch.core import bit_importance as TBI
from repro_torch.core import flexhyca as TF
from repro_torch.core import perfmodel as TP
from repro_torch.core import pipeline as TPL
from repro_torch.core import prng
from repro_torch.core import quantization as TQ
from repro_torch.core import strategies as TS

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for this module's GP solves, in both packages: their
    matrices are at most a few hundred wide, where OpenBLAS's threads only
    spin, and the suite runs in parallel worker processes whose spinning
    pools take each other's cores (a DSE case here took 1-3 s alone and
    24-44 s beside a second run of this suite)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


# quant_error is a float32 RMS ratio: each framework sums its squares in its
# own order, so the two may part in the last places of float32
QUANT_ERROR_RTOL = 1e-6


def _fields(obj):
    """A dataclass (policy, result) as plain nested values, so objects of
    the two packages compare field by field."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_fields(v) for v in obj)
    return obj


# ------------------------------------------------------------------ area --
def test_area_model_equal():
    for c in range(17):
        assert TA.pp_count(c) == JA.pp_count(c)
    assert TA.pe_cost() == JA.pe_cost()
    assert TA.full_tmr_pe_cost() == JA.full_tmr_pe_cost()
    for s in range(0, 9):
        for q in (0, 3, 4, 5, 7, 12, 16):
            assert TA.important_columns(s, q) == JA.important_columns(s, q)
            assert TA.important_acc_bits(s, q) == JA.important_acc_bits(s, q)
            for pol in ("direct", "configurable"):
                assert (_fields(TA.bit_protect_cost(s, q, pol))
                        == _fields(JA.bit_protect_cost(s, q, pol)))
                assert (TA.protected_pe_cost(s, q, pol)
                        == JA.protected_pe_cost(s, q, pol))
    for args in ((32, 1, 7, "configurable", 52, 2),
                 (32, 3, 7, "configurable", 52, 2),
                 (32, 1, 7, "configurable", 52, 4),
                 (16, 0, 0, "direct", 8, 8), (64, 2, 4, "direct", 128, 3)):
        assert TA.array_area(*args) == JA.array_area(*args)


# ------------------------------------------------------------- perfmodel --
def _layer_sets(P):
    return (P.lm_layer_gemms(6, 256, 1024, 8, 32, 8, seq=512,
                             sensitive_frac=0.5),
            P.lm_layer_gemms(4, 256, 1024, 8, 32, 8, seq=128),
            P.lm_layer_gemms(2, 128, 512, 4, 32, 4, seq=64))


def test_perfmodel_equal():
    for tl, jl in zip(_layer_sets(TP), _layer_sets(JP)):
        assert _fields(tl) == _fields(jl)
        for dim, dot, reuse in ((32, 52, True), (32, 64, False),
                                (32, 1, True), (16, 8, True)):
            tc = TP.DlaConfig(array_dim=dim, dot_size=dot, data_reuse=reuse)
            jc = JP.DlaConfig(array_dim=dim, dot_size=dot, data_reuse=reuse)
            for kind in ("base", "crt", "alg", "arch", "cl"):
                for s in (0.0, 0.02, 0.05, 0.1, 0.2, 0.4):
                    assert (TP.perf_loss(tl, tc, kind, s_th=s)
                            == JP.perf_loss(jl, jc, kind, s_th=s))
                    assert (TP.io_bytes(tl, tc, kind, s_th=s)
                            == JP.io_bytes(jl, jc, kind, s_th=s))



def test_vgg16_gemms_equal_benchmark_workload():
    """The port's VGG16 GEMM table (the DSE's perf/IO workload) is
    benchmarks/workloads.py's, layer for layer, sensitive set included."""
    from benchmarks.workloads import vgg16_gemms
    assert _fields(TP.vgg16_gemms()) == _fields(vgg16_gemms())

# -------------------------------------------------------------- bayesopt --
def synthetic_eval(B):
    def ev(cfg):
        prot = cfg["s_th"] * 4 + cfg["ib_th"] * 0.08 + cfg["nb_th"] * 0.3
        area = prot * (0.5 if cfg["pe_policy"] == "configurable" else 1.0)
        area += cfg["dot_size"] / 512
        acc = min(0.70 + prot * 0.25, 0.78)
        perf = 0.0 if cfg["dot_size"] >= 16 else 0.2
        return B.EvalResult(area=area, acc=acc, perf_loss=perf,
                            bw_loss=cfg["s_th"])
    return ev


def strict_eval(B):
    def ev(cfg):
        prot = cfg["s_th"] * 4 + cfg["ib_th"] * 0.08 + cfg["nb_th"] * 0.3
        return B.EvalResult(area=prot, acc=0.70 + prot * 0.08,
                            perf_loss=0.0, bw_loss=0.0)
    return ev


def _dse(B, ev, cons, batched, **kw):
    batches = []

    def eval_batch(cfgs):
        batches.append(len(cfgs))
        return [ev(B)(c) for c in cfgs]
    res = B.bayes_design_opt(B.table1_space(), ev(B), B.Constraints(**cons),
                             evaluate_batch=eval_batch if batched else None,
                             **kw)
    return _fields(res), batches


DSE_CASES = [
    # (eval, constraints, batched, kwargs): test_bayesopt.py's runs, then
    # test_batched_dse.py's synthetic ones
    (synthetic_eval, dict(acc_min=0.75, perf_max=0.10, bw_max=0.10), False,
     dict(iter_max_step=48, seed=0)),
    (synthetic_eval, dict(acc_min=0.99), False,
     dict(iter_max_step=24, seed=2)),
    (synthetic_eval, dict(acc_min=0.75), False,
     dict(iter_max_step=48, seed=3)),
    (synthetic_eval, dict(acc_min=0.75), True,
     dict(iter_max_step=48, seed=3, batch_size=4)),
    (synthetic_eval, dict(acc_min=0.75), True,
     dict(iter_max_step=48, seed=0, batch_size=1)),
] + [(strict_eval, dict(acc_min=0.80, perf_max=0.5, bw_max=0.5), batched,
      dict(iter_max_step=80, n_init=30, n_candidates=512, seed=seed,
           batch_size=4 if batched else 1))
     for seed in range(2) for batched in (False, True)]


@pytest.mark.parametrize("case", range(len(DSE_CASES)))
def test_bayes_design_opt_equal(case):
    """The same proposals in the same order, the same best, evaluations
    and pruned count: the port's copy draws from the same
    ``np.random.default_rng(seed)``."""
    ev, cons, batched, kw = DSE_CASES[case]
    assert _dse(TB, ev, cons, batched, **kw) == _dse(JB, ev, cons, batched,
                                                    **kw)


def test_gp_posterior_equal():
    X = np.random.default_rng(0).uniform(size=(20, 3))
    y = X.sum(1)
    out = []
    for B in (TB, JB):
        gp = B._GP()
        gp.fit(X, y)
        out.append(gp.posterior(X[:5]))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert _fields(TB.table1_space()) == _fields(JB.table1_space())


# -------------------------------------------------------- bit importance --
def test_bit_importance_equal():
    for kw in ({}, dict(q_scale=7), dict(bits=4, policy="direct",
                                         s_th=0.1, dot_size=16)):
        assert (TBI.protection_cost_table(**kw)
                == JBI.protection_cost_table(**kw))
    table = {(ib, nb): ib + 3 * nb for ib in range(9) for nb in range(ib + 1)}
    oracles = (
        (lambda ib, nb: 0.5 + 0.05 * ib + 0.04 * nb, 0.80, table),
        (lambda ib, nb: 1.0 if (ib >= 6 and nb >= 2) else 0.0, 0.5, table),
        (lambda ib, nb: 0.0, 0.9, None),
        (lambda ib, nb: 0.6 + 0.03 * ib + 0.05 * nb, 0.85, None))
    for oracle, target, tab in oracles:
        runs = []
        for BI in (TBI, JBI):
            calls = []

            def counted(ib, nb):
                calls.append((ib, nb))
                return oracle(ib, nb)
            best = BI.get_bit_config(counted, acc_target=target, bits=8,
                                     cost_table=tab)
            runs.append((_fields(best), calls))
        assert runs[0] == runs[1]


# ------------------------------------------- registry, policies, strategies
def test_registry_and_perf_kind_equal():
    assert tft.list_policies() == jft.list_policies()
    tp, jp = tft.paper_policies(), jft.paper_policies()
    assert list(tp) == list(jp)
    for name in tp:
        assert _fields(tp[name]) == _fields(jp[name])
        assert tp[name].perf_kind == jp[name].perf_kind
    cl = tft.get_policy("cl", s_th=0.1, ib_th=4)
    assert tft.paper_policies(cl)["cl"] is cl


def test_register_policy_name_and_overwrite():
    pol = tft.get_policy("crt1").tune(name="crt1_copy")
    try:
        tft.register_policy(pol, name="test_torch_paper_x")
        assert tft.get_policy("test_torch_paper_x") == pol
        with pytest.raises(ValueError, match="overwrite=True"):
            tft.register_policy(pol, name="test_torch_paper_x")
        other = tft.get_policy("crt2")
        tft.register_policy(other, name="test_torch_paper_x", overwrite=True)
        assert tft.get_policy("test_torch_paper_x") == other
        assert "test_torch_paper_x" in tft.list_policies()
    finally:
        from repro_torch.ft import registry
        registry._REGISTRY.pop("test_torch_paper_x", None)


def test_strategies_equal():
    layers = (TP.lm_layer_gemms(6, 256, 1024, 8, 32, 8, seq=512,
                                sensitive_frac=0.5),
              JP.lm_layer_gemms(6, 256, 1024, 8, 32, 8, seq=512,
                                sensitive_frac=0.5))
    for cl in (None, "fields"):
        tcl = jcl = None
        if cl:
            tcl = TF.FTConfig(ber=1e-3, s_th=0.1, ib_th=4, nb_th=2,
                              q_scale=4)
            jcl = JF.FTConfig(ber=1e-3, s_th=0.1, ib_th=4, nb_th=2,
                              q_scale=4)
        ts, js = TS.make_strategies(tcl), JS.make_strategies(jcl)
        assert list(ts) == list(js)
        for name in ts:
            t, j = ts[name], js[name]
            assert _fields(t.policy) == _fields(j.policy)
            assert _fields(t.with_ber(2e-3)) == _fields(j.with_ber(2e-3))
            for dim in (16, 32):
                assert t.area_relative(dim) == j.area_relative(dim)
                assert t.perf_loss(layers[0], dim) == j.perf_loss(layers[1],
                                                                  dim)
                assert t.extra_io(layers[0], dim) == j.extra_io(layers[1],
                                                                dim)


# ------------------------------------------ the DSE entry point (pipeline)
def test_batch_oracles_equal():
    rng = np.random.default_rng(0)
    space = JB.table1_space()
    cfgs = [{p.name: p.values[rng.integers(len(p.values))] for p in space}
            for _ in range(25)]
    out = []
    for PL, P, ft in ((TPL, TP, tft), (JPL, JP, jft)):
        pols = [PL._policy_from_cfg(c, 1e-3) for c in cfgs]
        pols += [ft.get_policy("arch", ber=1e-3), ft.get_policy(
            "alg", ber=1e-3), ft.get_policy("crt2", ber=1e-3),
            ft.get_policy("base")]
        layers = P.lm_layer_gemms(4, 256, 1024, 8, 32, 8, seq=128)
        perf, bw = PL.batch_perf_bw(pols, layers, 32)
        accs = [0.5 + 0.01 * i for i in range(len(pols))]
        out.append((_fields(pols), PL.batch_area_overhead(pols, 32), perf,
                    bw, _fields(PL.evaluate_policies(pols, accs, layers,
                                                     32))))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1:4], out[1][1:4]):
        np.testing.assert_array_equal(a, b)
    assert out[0][4] == out[1][4]
    assert TPL.TRAIN_AXES == JPL.TRAIN_AXES


def _fake_acc(pol):
    prot = (pol.algorithm.s_th * 4 + pol.circuit.ib_th * 0.08
            + pol.circuit.nb_th * 0.3)
    return min(0.70 + prot * 0.25, 0.78)


@pytest.mark.parametrize("batch_size", (1, 6))
def test_optimize_equal(batch_size):
    """test_batched_dse.py::test_optimize_batched_pipeline, both packages:
    the same DSE history, best policy and area overhead."""
    out = []
    for PL, P, B in ((TPL, TP, TB), (JPL, JP, JB)):
        layers = P.lm_layer_gemms(2, 128, 512, 4, 32, 4, seq=64)
        cons = B.Constraints(acc_min=0.75, perf_max=2.0, bw_max=2.0)
        calls = []

        def acc_batch(pols):
            calls.append(len(pols))
            return [_fake_acc(p) for p in pols]
        res = PL.optimize(_fake_acc, layers, cons, 1e-3, iter_max_step=24,
                          seed=1, batch_size=batch_size,
                          acc_oracle_batch=acc_batch if batch_size > 1
                          else None)
        out.append((_fields(res.policy), _fields(res.dse),
                    res.area_overhead, calls))
    assert out[0] == out[1]
    assert out[0][0] is not None


# ------------------------------------------------ flexhyca and quantization
@pytest.fixture(scope="module")
def xw():
    x = jax.random.normal(jax.random.PRNGKey(0), (64, 48))
    w = jax.random.normal(jax.random.PRNGKey(1), (48, 32))
    return x, w


FLEX_CASES = [
    # (FTConfig fields, key seed, important channels, layer_protected):
    # tests/test_flexhyca.py's cases
    (dict(ber=0.0, strategy="cl", q_scale=0), 0, 0, True),
    (dict(ber=0.01, strategy="base"), 0, None, True),
    (dict(ber=0.01, strategy="crt1", weight_faults=False), 5, None, True),
    (dict(ber=0.01, strategy="crt3", weight_faults=False), 5, None, True),
    (dict(ber=0.005, strategy="arch", weight_faults=False), 100, None, True),
    (dict(ber=0.01, strategy="arch", weight_faults=False), 2, None, False),
    (dict(ber=0.02, strategy="cl", ib_th=8, nb_th=0, q_scale=0,
          weight_faults=False), 3, 8, True),
]


@pytest.mark.parametrize("case", range(len(FLEX_CASES)))
def test_ft_linear_equal(xw, case):
    """The deprecated shim warns and gives the reference's output bitwise
    (the reference backend, through ``from_ftconfig``)."""
    fields, seed, n_imp, lp = FLEX_CASES[case]
    x, w = xw
    jimp = timp = None
    if n_imp is not None:
        jimp = jnp.zeros((32,), bool).at[:n_imp].set(True)
        timp = torch.from_numpy(np.array(jimp))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = JF.ft_linear(jax.random.PRNGKey(seed), x, w,
                            JF.FTConfig(**fields), important=jimp,
                            layer_protected=lp)
    with pytest.warns(DeprecationWarning, match="protect_linear"):
        got = TF.ft_linear(prng.PRNGKey(seed), torch.from_numpy(
            np.array(x)), torch.from_numpy(np.array(w)),
            TF.FTConfig(**fields), important=timp, layer_protected=lp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pol = tft.as_policy(TF.FTConfig(**fields))
    assert _fields(pol) == _fields(jft.as_policy(JF.FTConfig(**fields)))
    assert _fields(TF.FTConfig()) == _fields(JF.FTConfig())


@pytest.mark.parametrize("q_scale", (0, 4, 7, 14))
def test_quantization_additions_equal(xw, q_scale):
    x, w = (np.array(a) for a in xw)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert _fields(TQ.QuantConfig(q_scale=q_scale)) == _fields(
        JQ.QuantConfig(q_scale=q_scale))
    q, s = TQ.quantize(tx)
    jq, js = JQ.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(TQ.dequantize(q, s).numpy(),
                                  np.asarray(JQ.dequantize(jq, js)))
    y, aux = TQ.fake_quant_linear(tx, tw, q_scale=q_scale)
    jy, jaux = JQ.fake_quant_linear(jnp.asarray(x), jnp.asarray(w),
                                    q_scale=q_scale)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    for k in ("xq", "wq", "t", "sx", "sw"):
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(jaux[k]))
    np.testing.assert_array_equal(TF.clean_linear(tx, tw, q_scale).numpy(),
                                  np.asarray(JF.clean_linear(
                                      jnp.asarray(x), jnp.asarray(w),
                                      q_scale)))
    err = float(TQ.quant_error(tx, q_scale))
    jerr = float(JQ.quant_error(jnp.asarray(x), q_scale))
    assert err == pytest.approx(jerr, rel=QUANT_ERROR_RTOL, abs=0)
