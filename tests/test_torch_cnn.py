"""The port's CNN paper path against the reference's, on the tiny oracle of
tests/test_batched_dse.py (vgg, channels (8,), 8x8 images, trained 60
steps in JAX, whose first step the SGD test reuses; n_eval 96, n_rep 2,
noise 0.8), its parameters carried across by
``convert.cnn_params_from_jax``.

``prng.normal`` is within 3 float32 ulps of ``jax.random.normal`` (not
bitwise: ``log1p`` is each framework's own), so the port's oracle is given
the reference oracle's evaluation images; its labels are bitwise its own.

Held, with the tolerance stated at each test:
  * accuracies: equal exactly to the JAX oracle's for cl, crt2 and arch with
    a protected set, on the port's ``reference`` and ``fused`` backends;
    ``accuracy_batch`` = the singles = ``_accuracy_looped``;
    ``layer_sensitivity`` and its cache key; a short ``optimize`` with the
    reference's history, best, evaluations and pruned count;
  * logits: clean and faulty within a stated float bound;
  * importance: scores within a float bound, masks equal;
  * one SGD step: parameters within a float bound;
  * the fused backend sends every protected conv and the head through the
    ``fused_decode`` kernel's wrapper.

The reference's vmapped accuracy compiles once per policy structure (and
protected set); each is made once per module and reused.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import ft as jft
from repro.core import bayesopt as JB
from repro.core import pipeline as JPL
from repro.core.evaluate import CnnOracle as JOracle
from repro.data.pipeline import vision_batch as jvision_batch
from repro.models import cnn as jcnn
from repro.models.common import FTCtx as JFTCtx
from repro_torch import ft as tft
from repro_torch.convert import cnn_params_from_jax
from repro_torch.core import bayesopt as TB
from repro_torch.core import pipeline as TPL
from repro_torch.core import prng
from repro_torch.core.evaluate import CnnOracle
from repro_torch.core.perfmodel import Gemm
from repro_torch.data.pipeline import vision_batch
from repro_torch.kernels.fused_decode import ops as fused_ops
from repro_torch.models import cnn as tcnn
from repro_torch.models.common import FTCtx

torch.set_num_threads(1)

CFG = dict(channels=(8,), hw=8)
ORACLE = dict(n_eval=96, n_rep=2, noise=0.8)
REF_STEPS = 60           # the reference's training steps of the oracle's net
BACKENDS = ("reference", "fused")
# logits: the reference's protect_linear is jitted, and XLA orders its
# rescale's float products its own way (ROADMAP.md §C), so faulty logits
# part by a few float32 ulps; clean ones by the matmul's summation order
LOGIT_ULPS = 8
# importance: float32 gradients of the same loss, summed in float64
IMPORTANCE_RTOL = 1e-6
# one SGD step: float32 gradients in each framework's order, applied with
# lr 3e-3 (the step moves parameters by ~1e-3; they part by ~1e-8)
STEP_ATOL = 1e-7
# prng.normal against jax.random.normal (vision_batch's images): erfinv
# within 2 ulps, times float32 sqrt(2); 3 is the most seen over 2e6 draws
NORMAL_ULPS = 3
# (name, ber, tune, protected_layers): test_batched_dse.py's policies and
# arch with one protected layer
POLICIES = {
    "cl": ("cl", 8e-3, dict(s_th=0.1, ib_th=3, nb_th=1, q_scale=4), None),
    "cl2": ("cl", 4e-3, dict(s_th=0.05, ib_th=2, nb_th=2, q_scale=7), None),
    "crt2": ("crt2", 4e-3, {}, None),
    "arch": ("arch", 8e-3, {}, frozenset({"s0_c0"})),
}


def _pol(ft, key):
    name, ber, tune, _ = POLICIES[key]
    return ft.get_policy(name, ber=ber, **tune)


class _Trained(Exception):
    """Raised from the reference's last training step: the oracle takes its
    parameters, not the final accuracy ``train_cnn`` goes on to evaluate
    eagerly on 512 images."""


@pytest.fixture(scope="module")
def ref_training():
    """The reference's 60 training steps of the tiny oracle's network:
    (its parameters, the parameters after its first step), read off its
    jitted step."""
    outs = []
    real_jit = jax.jit

    def recording_jit(f, *a, **kw):
        jitted = real_jit(f, *a, **kw)
        if getattr(f, "__name__", "") != "step":
            return jitted

        def call(*args):
            out = jitted(*args)
            outs.append(out[0])
            if len(outs) == REF_STEPS:
                raise _Trained
            return out
        return call
    with pytest.MonkeyPatch.context() as mp, pytest.raises(_Trained):
        mp.setattr(jax, "jit", recording_jit)
        jcnn.train_cnn(jax.random.PRNGKey(0), jcnn.CNNConfig(**CFG),
                       steps=REF_STEPS)
    return outs[-1], jax.tree.map(np.asarray, outs[0])


@pytest.fixture(scope="module")
def ref(ref_training):
    return JOracle(ref_training[0], jcnn.CNNConfig(**CFG), **ORACLE)


@pytest.fixture(scope="module")
def ref_acc(ref):
    """The reference oracle's accuracy per policy key, each made once."""
    @functools.cache
    def acc(key):
        return ref.accuracy(_pol(jft, key), protected_layers=POLICIES[key][3])
    return acc


@pytest.fixture(scope="module")
def port(ref):
    params = cnn_params_from_jax(jax.tree.map(np.asarray, ref.params),
                                 device="cpu")
    out = {}
    for b in BACKENDS:
        o = CnnOracle(params, tcnn.CNNConfig(**CFG), backend=b, device="cpu",
                      **ORACLE)
        np.testing.assert_array_equal(o._labels.numpy(),
                                      np.asarray(ref._labels))
        o._imgs = torch.from_numpy(np.array(ref._imgs))
        out[b] = o
    return out


@pytest.fixture(scope="module")
def port_acc(port):
    """The port oracle's accuracy per (backend, policy key), made once."""
    @functools.cache
    def acc(backend, key):
        return port[backend].accuracy(_pol(tft, key),
                                      protected_layers=POLICIES[key][3])
    return acc


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


# ------------------------------------------------------------- the data --
def test_vision_batch_and_normal(ref):
    """Labels bitwise (``randint``); ``normal`` within NORMAL_ULPS of
    ``jax.random.normal``, so the images within that many ulps of the
    noise term plus the sum's rounding (the reference oracle's evaluation
    set: key 7, 96 images)."""
    ti, tl = vision_batch(prng.PRNGKey(7), 96, 8, 8, noise=0.8)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(ref._labels))
    ji = np.asarray(ref._imgs)
    ulp = np.spacing(np.abs(ji).max())
    assert np.abs(ti.numpy() - ji).max() <= (0.8 * NORMAL_ULPS + 1) * ulp
    jn = jax.random.normal(jax.random.PRNGKey(99), (8, 8, 8, 1))
    assert _ulps(jn, prng.normal(prng.PRNGKey(99), (8, 8, 8, 1))).max() \
        <= NORMAL_ULPS


# -------------------------------------------------------- the CNN itself --
@pytest.mark.parametrize("arch", ("vgg", "resnet"))
def test_init_cnn_tree(arch):
    """init_cnn's tree has the reference's names and shapes (its draws are
    the port's own)."""
    cfg = dict(arch=arch, channels=(8, 16), hw=8)
    want = jax.eval_shape(lambda k: jcnn.init_cnn(k, jcnn.CNNConfig(**cfg)),
                          jax.random.PRNGKey(1))
    got = tcnn.init_cnn(torch.Generator().manual_seed(1),
                        tcnn.CNNConfig(**cfg), "cpu")
    assert ({k: {n: tuple(v.shape) for n, v in d.items()}
             for k, d in got.items()}
            == {k: {n: tuple(v.shape) for n, v in d.items()}
                for k, d in want.items()})


@pytest.mark.parametrize("arch", ("vgg", "resnet"))
def test_clean_logits(ref, port, arch):
    """apply_cnn on the reference's parameters gives its clean logits
    within LOGIT_ULPS of the largest: the trained tiny vgg on the oracle's
    images, and a resnet (stem, projection shortcut) from init_cnn."""
    if arch == "vgg":
        jp, jcfg, imgs = ref.params, ref.cfg, ref._imgs
        tp, tcfg = port["fused"].params, port["fused"].cfg
    else:
        jcfg = jcnn.CNNConfig(arch=arch, channels=(8, 16), hw=8)
        jp = jcnn.init_cnn(jax.random.PRNGKey(1), jcfg)
        tp = cnn_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        tcfg = tcnn.CNNConfig(arch=arch, channels=(8, 16), hw=8)
        imgs = ref._imgs[:16]
    want = np.asarray(jax.jit(jcnn.apply_cnn, static_argnums=1)(jp, jcfg,
                                                                 imgs))
    with torch.no_grad():
        got = tcnn.apply_cnn(tp, tcfg, torch.from_numpy(np.array(imgs)))
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got.numpy() - want).max() <= LOGIT_ULPS * ulp


def test_faulty_logits(ref, port):
    """One faulty forward (cl at BER 8e-3, one key) on both backends: the
    same argmax per image as the reference, logits within LOGIT_ULPS of
    the largest."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda p, x, k: jcnn.apply_cnn(
        p, ref.cfg, x, ftc=JFTCtx(_pol(jft, "cl"), k)))(
            ref.params, ref._imgs, key))
    ulp = np.spacing(np.float32(np.abs(want).max()))
    for b, o in port.items():
        with torch.no_grad():
            got = tcnn.apply_cnn(o.params, o.cfg, o._imgs, ftc=FTCtx(
                _pol(tft, "cl"), prng.as_key(np.asarray(key)),
                backend=b)).numpy()
        assert np.abs(got - want).max() <= LOGIT_ULPS * ulp, b
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ------------------------------------------------------- the accuracies --
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("key", ("cl", "crt2", "arch"))
def test_accuracy_equals_reference(ref_acc, port_acc, backend, key):
    assert port_acc(backend, key) == ref_acc(key)


def test_clean_accuracy_equals_reference(ref, port):
    for o in port.values():
        assert o.accuracy(None) == ref.accuracy(None)


def test_accuracy_batch_equals_singles_and_looped(ref_acc, port_acc, port):
    """The batch (canonical structure, knobs through ``dyn``) = the singles
    = the looped path, exactly, with a clean candidate mixed in; and the
    reference's numbers."""
    o = port["fused"]
    batched = o.accuracy_batch([None] + [_pol(tft, k) for k in
                                         ("cl", "cl2", "crt2")])
    assert batched[0] == o.accuracy(None)
    assert batched[1] == port_acc("fused", "cl") == ref_acc("cl")
    assert batched[2] == o._accuracy_looped(_pol(tft, "cl2"))
    assert batched[3] == port_acc("fused", "crt2") == ref_acc("crt2")


def test_fused_backend_runs_every_site_through_the_kernel(monkeypatch, port):
    """Every protected GEMM of a fused forward (2 convs and the head) calls
    the fused_decode kernel's wrapper: n_rep x 3 calls, all in the global-t
    mode, and no importance mask reaches one (the reference keys its masks
    by tap name, ``"{site}/out"``, and looks them up by site name)."""
    calls = []
    real = fused_ops.fused_decode

    def counted(xq, wq, *a, **kw):
        calls.append((tuple(xq.shape), tuple(wq.shape), kw["per_row"],
                      kw["dppu_src"]))
        return real(xq, wq, *a, **kw)
    monkeypatch.setattr(fused_ops, "fused_decode", counted)
    o = port["fused"]
    o.accuracy(_pol(tft, "cl"))
    n = ORACLE["n_eval"]
    assert calls == [((n * 64, 9), (9, 8), False, "none"),
                     ((n * 64, 72), (72, 8), False, "none"),
                     ((n, 128), (128, 8), False, "none")] * ORACLE["n_rep"]
    assert set(o.masks(0.1)) == {"s0_c0/out", "s0_c1/out"}


def test_layer_sensitivity_and_cache(ref, port_acc, port):
    """Fig. 5 equals the reference oracle's exactly (arch at BER 8e-3, each
    layer protected alone, less none protected); the memo is keyed on
    (ber, seed, n_rep)."""
    o = port["fused"]
    sens = o.layer_sensitivity(8e-3)
    assert sens == ref.layer_sensitivity(8e-3)
    assert list(sens) == ["s0_c0", "s0_c1"]
    none = o.accuracy(_pol(tft, "arch"), protected_layers=set())
    assert sens["s0_c0"] == port_acc("fused", "arch") - none
    assert (8e-3, 0, o.n_rep) in o._sens_cache
    assert o.layer_sensitivity(8e-3) is sens          # a cache hit
    o.n_rep = 1
    try:
        assert (8e-3, 0, 1) not in o._sens_cache
        o._sens_cache[(8e-3, 0, 1)] = marker = {}
        assert o.layer_sensitivity(8e-3) is marker    # keyed on n_rep
    finally:
        o.n_rep = ORACLE["n_rep"]
        del o._sens_cache[(8e-3, 0, 1)]


def test_importance_scores_and_masks(ref, port):
    """Algorithm 1 on the port's own calibration batches: scores within
    IMPORTANCE_RTOL of the reference's largest, masks equal."""
    want, got = ref.importance(), port["fused"].importance()
    assert list(got.scores) == list(want.scores)
    for k, v in want.scores.items():
        np.testing.assert_allclose(got.scores[k], v, rtol=0,
                                   atol=IMPORTANCE_RTOL * np.abs(v).max())
    for s_th in (0.05, 0.1, 0.25, 0.5):
        for pol in ("uniform", "global"):
            mw, mg = want.select(s_th, pol), got.select(s_th, pol)
            for k in mw:
                np.testing.assert_array_equal(mg[k], mw[k])


def test_one_sgd_step(ref_training):
    """train_cnn's step (``sgd_step``, momentum 0.9, lr 3e-3) from the
    reference's initial parameters on its first batch (the port's
    ``vision_batch(fold_in(key, 0))``): parameters within STEP_ATOL of the
    reference ``train_cnn``'s after its first step."""
    cfg = jcnn.CNNConfig(**CFG)
    key = jax.random.PRNGKey(0)
    want = ref_training[1]
    init = jcnn.init_cnn(key, cfg)
    params = cnn_params_from_jax(jax.tree.map(np.asarray, init),
                                 device="cpu")
    imgs, labels = vision_batch(prng.fold_in(prng.PRNGKey(0), 0), 64, 8, 8,
                                noise=1.6)
    mom = {k: {n: torch.zeros_like(t) for n, t in d.items()}
           for k, d in params.items()}
    got, _ = tcnn.sgd_step(params, mom, imgs, labels, tcnn.CNNConfig(**CFG),
                           3e-3)
    for layer, leaves in want.items():
        for k, v in leaves.items():
            moved = np.abs(np.asarray(v) - np.asarray(init[layer][k])).max()
            assert moved > 100 * STEP_ATOL, (layer, k)
            np.testing.assert_allclose(got[layer][k].numpy(), np.asarray(v),
                                       rtol=0, atol=STEP_ATOL)


def test_short_optimize_equals_reference(ref, port):
    """optimize() on the accuracy oracles over the paper's VGG16 GEMMs
    (benchmarks/workloads.py; 6 evaluations in batches of 3): the same
    candidates, accuracies and areas, best, evaluations and pruned count."""
    from benchmarks.workloads import vgg16_gemms
    o = port["fused"]
    clean = o.accuracy(None)
    jlayers = vgg16_gemms()
    tlayers = [Gemm(g.name, g.M, g.K, g.N, g.sensitive) for g in jlayers]
    out = []
    for PL, B, oracle, layers in ((TPL, TB, o, tlayers),
                                  (JPL, JB, ref, jlayers)):
        res = PL.optimize(oracle.accuracy, layers,
                          B.Constraints(acc_min=0.9 * clean, perf_max=0.1,
                                        bw_max=0.1),
                          ber=2e-3, iter_max_step=6, seed=1, batch_size=3,
                          acc_oracle_batch=oracle.accuracy_batch)
        out.append(([(c, r.acc, r.area) for c, r in res.dse.history],
                    res.dse.best, res.dse.evaluations, res.dse.pruned,
                    res.area_overhead))
    assert out[0] == out[1]
    assert out[0][2] >= 6 and out[0][1] is not None
