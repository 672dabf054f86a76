"""Fault-aware training (FAT) in the port against the reference: the
straight-through ``protect_linear_ste``, the BER ramp, ``train_cnn(fat=)``
on the tiny CNN of tests/test_torch_cnn.py, ``trained_cnn_fat`` and
``FatCnnOracle``, and the ``EmuCtx`` cost emulation.

Held, with the tolerance stated at each test:
  * the STE's forward is ``protect_linear``'s output bit for bit, and equal
    to the reference's ``protect_linear_ste`` run op by op (its jitted
    rescale may reorder float products: ROADMAP.md §C), on the port's
    ``reference`` and ``fused`` backends; its gradients are the clean
    float32 matmul's, within STE_GRAD_RTOL of the largest of ``jax.grad``'s;
  * ``fat_ber_at`` equals the reference's float32 ramp, and ``train_cnn``
    draws each step's BER as the reference's does;
  * two FAT steps of ``train_cnn`` from the reference's initial weights
    give its parameters within FAT_STEP_ATOL;
  * ``trained_cnn_fat(fat_ber=0)`` is ``trained_cnn``; ``FatCnnOracle.batch``
    equals its singles;
  * ``EmuCtx``: test_ft_emu.py's two cases, against the reference.

The reference's FAT training jits one step, and its STE runs op by op;
each is made once per module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ft as jft
from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRun
from repro.models import build as jbuild
from repro.models import cnn as jcnn
from repro.models.common import EmuCtx as JEmuCtx
from repro.models.common import linear as jlinear
from repro.train.train_step import fat_ber_at as jfat_ber_at
from repro_torch import ft as tft
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.convert import cnn_params_from_jax, params_from_jax
from repro_torch.core import evaluate as tev
from repro_torch.core import prng
from repro_torch.kernels.fused_decode import ops as fused_ops
from repro_torch.models import build as tbuild
from repro_torch.models import cnn as tcnn
from repro_torch.models.common import EmuCtx, FTCtx, linear
from repro_torch.train.train_step import fat_ber_at
from repro_torch.tree import leaves as tree_leaves

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

CFG = dict(channels=(8,), hw=8)
BACKENDS = ("reference", "fused")
# STE gradients: float32 matmuls summed in each framework's order
STE_GRAD_RTOL = 1e-6
# two FAT SGD steps (lr 3e-3) from the same weights: float32 gradients in
# each framework's order through the bitwise faulty datapath, and the
# reference's jitted rescale a few ulps off the port's; a different
# quantization rounding would move a parameter by ~1e-4
FAT_STEP_ATOL = 1e-6
FAT = dict(fat="cl", fat_ber=8e-3, steps=2)
# the emulated two_pass loss, the port against the reference: float32 sums
# in each framework's order
EMU_LOSS_ATOL = 1e-5


def _xw(seed, m=6, k=40, n=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


# ------------------------------------------------------------------ STE --
@functools.cache
def _ste_reference(name, ber):
    """The reference's protect_linear_ste on _xw(3), op by op, once per
    policy (both backends are held to it)."""
    x, w = _xw(3)
    with jax.disable_jit():
        return np.asarray(jft.protect_linear_ste(
            jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(w),
            jft.get_policy(name, ber=ber)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("policy", (("cl", 2e-2), ("base", 5e-2),
                                    ("arch", 1e-2)))
def test_ste_forward_bitwise(backend, policy):
    """test_fat_train.py's policies at BERs where faults land: the port's
    STE forward = its protect_linear = the reference's protect_linear_ste
    op by op, bitwise."""
    name, ber = policy
    x, w = _xw(3)
    jkey = jax.random.PRNGKey(3)
    want = _ste_reference(name, ber)
    pol = tft.get_policy(name, ber=ber)
    key = prng.as_key(np.asarray(jkey))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = tft.protect_linear_ste(key, xt, wt, pol, backend=backend)
    plain = tft.protect_linear(key, torch.from_numpy(x), torch.from_numpy(w),
                               pol, backend=backend)
    assert got.requires_grad
    np.testing.assert_array_equal(got.detach().numpy(), plain.numpy())
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert (want != x @ w).any()                   # faults landed


@pytest.mark.parametrize("backend", BACKENDS)
def test_ste_backward_is_clean_matmul(backend):
    """d/dx, d/dw of sum(y**2) through the STE: the cotangent 2y (y the
    faulty output) through the clean matmul's transpose, against
    ``jax.grad`` of the reference's STE, within STE_GRAD_RTOL of the
    largest; a bf16 operand gets its gradient back in bf16."""
    x, w = _xw(1)
    jkey = jax.random.PRNGKey(3)
    jpol = jft.get_policy("cl", ber=2e-3)
    with jax.disable_jit():
        jgx, jgw = jax.grad(lambda a, b: (jft.protect_linear_ste(
            jkey, a, b, jpol) ** 2).sum(), argnums=(0, 1))(
                jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tft.protect_linear_ste(prng.as_key(np.asarray(jkey)), xt, wt,
                               tft.get_policy("cl", ber=2e-3),
                               backend=backend)
    gx, gw = torch.autograd.grad((y ** 2).sum(), (xt, wt))
    for want, got in ((jgx, gx), (jgw, gw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=STE_GRAD_RTOL * np.abs(want).max())
    wb = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    yb = tft.protect_linear_ste(prng.PRNGKey(3), xt, wb,
                                tft.get_policy("cl", ber=2e-3),
                                backend=backend)
    (gwb,) = torch.autograd.grad(yb.sum(), (wb,))
    assert gwb.dtype == torch.bfloat16


def test_ftctx_ste_routes_linear_through_the_ste(monkeypatch):
    """``FTCtx(ste=True)``: ``linear`` calls the STE (every site of a
    forward), and its output equals ``ste=False``'s bitwise."""
    import repro_torch.ft as ftmod
    calls = []
    real = ftmod.protect_linear_ste

    def counted(*a, **kw):
        calls.append(kw["backend"])
        return real(*a, **kw)
    monkeypatch.setattr(ftmod, "protect_linear_ste", counted)
    x, w = _xw(2)
    pol = tft.get_policy("crt1", ber=2e-2)
    outs = [linear(torch.from_numpy(x), torch.from_numpy(w),
                   ftc=FTCtx(pol, prng.PRNGKey(4), backend="fused",
                             ste=ste), name="s0_c0")
            for ste in (False, True)]
    assert calls == ["fused"]
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].detach().numpy())


# ------------------------------------------------------------- the ramp --
def test_fat_ber_ramp_equals_reference():
    """float32 ramp values equal the reference's bit for bit: 15 steps of a
    10-step ramp, no ramp, and a device-tensor step."""
    for ramp in (10, 0, 3):
        for s in range(15):
            want = np.float32(jfat_ber_at(2e-3, ramp, s))
            got = fat_ber_at(2e-3, ramp, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert got.item() == want, (ramp, s)


# ----------------------------------------------------- FAT CNN training --
class _Trained(Exception):
    """Raised from the reference's last training step: the tests hold its
    parameters, not the final accuracy ``train_cnn`` goes on to evaluate
    eagerly on 512 images."""


@pytest.fixture(scope="module")
def fat_reference():
    """The reference's train_cnn(fat="cl", steps=2) on the tiny CNN: its
    parameters, its initial ones, and the BER of each of its steps as its
    jitted step received it."""
    bers = []
    real_jit = jax.jit

    def recording_jit(f, *a, **kw):
        jitted = real_jit(f, *a, **kw)
        if getattr(f, "__name__", "") != "step":
            return jitted

        def call(params, mom, k, ber):
            bers.append(np.float32(ber))
            out = jitted(params, mom, k, ber)
            if len(bers) == FAT["steps"]:
                raise _Trained(out[0])
            return out
        return call
    cfg = jcnn.CNNConfig(**CFG)
    with pytest.MonkeyPatch.context() as mp, pytest.raises(_Trained) as done:
        mp.setattr(jax, "jit", recording_jit)
        jcnn.train_cnn(jax.random.PRNGKey(0), cfg, **FAT)
    init = jcnn.init_cnn(jax.random.PRNGKey(0), cfg)
    return (jax.tree.map(np.asarray, done.value.args[0]),
            jax.tree.map(np.asarray, init), bers)


def test_train_cnn_fat_equals_reference(monkeypatch, fat_reference):
    """Two FAT steps (cl, ramp 0 -> 8e-3 over 1 step) from the reference's
    initial weights: every step's BER equal, parameters within
    FAT_STEP_ATOL, and the FAT forward reached every site of both steps
    through the STE (3 sites x 2 steps)."""
    want, init, want_bers = fat_reference
    import repro_torch.ft as ftmod
    bers, real = [], ftmod.protect_linear_ste

    def counted(key, x, w, policy, *a, **kw):
        bers.append(np.float32(policy.ber.item()))
        return real(key, x, w, policy, *a, **kw)
    monkeypatch.setattr(ftmod, "protect_linear_ste", counted)
    monkeypatch.setattr(tcnn, "init_cnn", lambda g, cfg, dev: (
        cnn_params_from_jax(init, device=dev)))
    got, acc = tcnn.train_cnn(prng.PRNGKey(0), tcnn.CNNConfig(**CFG), **FAT)
    assert want_bers == [np.float32(0.0), np.float32(8e-3)]
    assert bers == [b for b in want_bers for _ in range(3)]
    for layer, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[layer][k].numpy(), v, rtol=0,
                                       atol=FAT_STEP_ATOL)
    assert 0.0 <= acc <= 1.0


def test_train_cnn_fat_moves_away_from_clean(monkeypatch, fat_reference):
    """The same two steps without ``fat``: the faults changed the
    parameters by more than the tolerance (the check above can fail)."""
    want, init, _ = fat_reference
    monkeypatch.setattr(tcnn, "init_cnn", lambda g, cfg, dev: (
        cnn_params_from_jax(init, device=dev)))
    clean, _ = tcnn.train_cnn(prng.PRNGKey(0), tcnn.CNNConfig(**CFG),
                              steps=2)
    moved = max(np.abs(clean[layer][k].numpy() - v).max()
                for layer, leaves in want.items() for k, v in leaves.items())
    assert moved > 100 * FAT_STEP_ATOL


# ------------------------------------------------ the fat_ber DSE axis --
@pytest.fixture(scope="module")
def fat_oracle():
    """FatCnnOracle over the tiny CNN (``CNNConfig(arch)`` made the tiny
    config in ``evaluate``) trained 2 steps on the CPU, each network's
    oracle cut to 32 images and one fault draw."""
    o = tev.FatCnnOracle("vgg", steps=2, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tev, "CNNConfig",
                   lambda arch: tcnn.CNNConfig(arch=arch, **CFG))
        for fb in (0.0, 2e-3):
            net = o.oracle(fb)
            net._imgs, net._labels = net._imgs[:32], net._labels[:32]
            net.n_rep = 1
    yield o
    tev.trained_cnn.cache_clear()
    tev.trained_cnn_fat.cache_clear()


def test_trained_cnn_fat_zero_is_trained_cnn(fat_oracle):
    base = tev.trained_cnn("vgg", 2, "cpu")
    assert tev.trained_cnn_fat("vgg", 2, 0.0, device="cpu") is base
    assert fat_oracle.oracle(0.0) is base
    fat = fat_oracle.oracle(2e-3)
    assert fat is not base and fat is tev.trained_cnn_fat(
        "vgg", 2, 2e-3, "cl", None, "cpu")
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(fat.params), tree_leaves(base.params)))


def test_fat_oracle_batch_equals_singles(fat_oracle, monkeypatch):
    """Candidates of two fat values, interleaved, with a clean one: the
    batch equals the singles exactly, each network's batch one group, and
    the fused backend ran every faulty lane (3 sites each)."""
    calls = []
    real = fused_ops.fused_decode

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    pols = [tft.get_policy("cl", ber=2e-3), None,
            tft.get_policy("crt2", ber=4e-3), tft.get_policy("cl", ber=2e-3)]
    fbs = [0.0, 2e-3, 2e-3, 2e-3]
    monkeypatch.setattr(fused_ops, "fused_decode", counted)
    batched = fat_oracle.batch(pols, fbs)
    assert len(calls) == 3 * 3
    singles = [fat_oracle(p, fb) for p, fb in zip(pols, fbs)]
    assert batched == singles
    assert batched[1] == fat_oracle.oracle(2e-3).accuracy(None)


# ---------------------------------------------------------------- EmuCtx --
def test_emu_linear_equals_reference():
    """test_ft_emu.py's first case: two_pass within 1e-5 of the plain
    matmul, fused equal to it; each within float32 summation order of the
    reference's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = linear(xt, wt).numpy()
    two = linear(xt, wt, ftc=EmuCtx("two_pass", 0.25)).numpy()
    fused = linear(xt, wt, ftc=EmuCtx("fused", 0.25)).numpy()
    np.testing.assert_allclose(two, plain, rtol=1e-5)
    np.testing.assert_array_equal(fused, plain)
    for mode, got in (("two_pass", two), ("fused", fused)):
        want = np.asarray(jlinear(jnp.asarray(x), jnp.asarray(w),
                                  ftc=JEmuCtx(mode, 0.25)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        EmuCtx("three_pass")


def _emu_losses():
    """The reference's two_pass loss of reduced danube, and the port's
    loss under each run.ft_emu mode ("" plain, two_pass, fused)."""
    jcfg = jget_config("h2o-danube-1.8b", reduced=True)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0,
                                       jcfg.vocab))
    run = dict(param_dtype="float32", compute_dtype="float32")
    jm = jbuild(jcfg, JRun(**run, ft_emu="two_pass"))
    jp = jm.init(jax.random.PRNGKey(0))
    want, _ = jax.jit(lambda p, b: jm.loss(p, b))(
        jp, {"tokens": jnp.asarray(toks)})
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    got = {}
    for mode in ("", "two_pass", "fused"):
        with torch.no_grad():
            got[mode] = float(tbuild(cfg, TRun(**run, ft_emu=mode)).loss(
                tp, {"tokens": torch.from_numpy(toks).long()})[0])
    return float(want), got


def test_emu_loss_matches_unprotected():
    """test_ft_emu.py's second case on the port (two_pass within 1e-4 of
    the plain loss, fused within 1e-6), and the two_pass loss within
    EMU_LOSS_ATOL of the reference's."""
    want, got = _emu_losses()
    assert abs(got[""] - got["two_pass"]) < 1e-4
    assert abs(got[""] - got["fused"]) < 1e-6
    assert abs(want - got["two_pass"]) <= EMU_LOSS_ATOL
