"""LM training in the port against the reference, on reduced
h2o-danube-1.8b in float32 (tests/test_train.py's model), the reference's
parameters and train state carried across by ``repro_torch.convert``.

Held, with the tolerance stated at each test:
  * the LM data stream (``lm_batch``, ``make_batch``, ``LMIterator`` and its
    state) bitwise; ``lr_at`` and ``adamw_update`` within ADAM_RTOL;
  * one train step, clean and under FAT (crt1 at a BER where faults land,
    mid-ramp), against the reference's jitted ``make_train_step`` from the
    same state: the loss (Model.loss) within LOSS_RTOL; the first moments,
    which after one step from zero are (1 - b1) x the clipped gradients,
    and the second moments within GRAD_RTOL of their largest; the
    parameters within PARAM_ATOL; under FAT every site's int8 operand
    equal but at a rounding tie (then FAT_RTOL), and the BER equal;
    ``grad_accum=2`` within tests/test_train.py's bounds of one batch;
  * in the port: ``remat="block"`` gives ``remat="none"``'s FAT step
    bitwise (the recompute draws the same keys), the donated (in-place)
    step gives the copying one's bitwise, and each microbatch draws from
    its own fold of the step key;
  * checkpoints: tests/test_checkpoint.py's cases on the port, and a
    checkpoint written by the reference (bf16 parameters included)
    restores into the port by name, bitwise;
  * the port's Trainer against itself, as tests/test_train.py holds the
    reference's: the loss falls, a restart (clean and under FAT) continues
    bitwise, stragglers are found on a bounded window that leaves the first
    step out, async writers never overlap;
  * ``launch/train.py --smoke`` trains on the CPU.

Each reference train step compiles once per module.
"""
import dataclasses
import functools
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jdata
from repro.models import build as jbuild
from repro.optim import adamw as jadamw
from repro.ft import api as japi
from repro.train import checkpoint as JC
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.core import prng
from repro_torch.core import quantization as Q
from repro_torch.data import pipeline as tdata
from repro_torch.models import build
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train import (Trainer, TrainerConfig, init_state,
                               make_decode_step, make_prefill_step,
                               make_train_step)
from repro_torch.train import checkpoint as C
from repro_torch.train import trainer as T
from repro_torch.train.trainer import _RunningMedian
from repro_torch.tree import items, leaves, tree_map

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
# the loss: float32 sums in each framework's order (it is O(6))
LOSS_RTOL = 1e-5
# gradients (read from the first moments) and squared gradients: float32
# matmuls in each framework's order, against the largest entry
GRAD_RTOL = 1e-4
# parameters after one AdamW step of lr 1e-3: each moves by lr x
# (m/sqrt(v) + decay), m/sqrt(v) within ~GRAD_RTOL of the reference's
PARAM_ATOL = 1e-6
# the FAT step, where one int8 operand sits on a rounding tie in the
# jitted reference (see test_fat_step_equals_reference)
FAT_RTOL = 1e-2
TIE_ATOL = 1e-5
# lr_at and adamw_update on the same float32 inputs: pow, sqrt and
# division rounded by each framework
ADAM_RTOL = 1e-6
OPT = dict(lr=1e-3)
BATCH = dict(B=4, S=32)
FAT = dict(policy="crt1", ft_ber=6e-3, fat_ramp=6)
FAT_COUNTER = 3              # the step counter the FAT step starts from
SHAPE = ShapeConfig("tiny", "train", 64, 8)


def tiny_model(grad_accum=1, n_layers=None, remat="block"):
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return build(cfg, RunConfig(**F32, grad_accum=grad_accum, remat=remat))


@functools.cache
def _reference():
    """(jax model, its initial state, the batch)."""
    jm = jbuild(jget_config("h2o-danube-1.8b", reduced=True), JRun(**F32))
    state = jinit_state(jm, jax.random.PRNGKey(0),
                        jadamw.AdamWConfig(**OPT))
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab, (BATCH["B"], BATCH["S"])).astype(np.int32)
    return jm, state, toks


def _port_state(counter=0):
    jm, state, _ = _reference()
    out = train_state_from_jax(jax.tree.map(np.asarray, state), jm.cfg,
                               device="cpu")
    out["step"] = torch.tensor(counter, dtype=torch.int32)
    return out


def _batch():
    return {"tokens": torch.from_numpy(_reference()[2]).long()}


@pytest.fixture(scope="module")
def ref_steps():
    """The reference's jitted train step from the initial state: "clean",
    and "fat" (crt1 from step counter FAT_COUNTER, mid-ramp), with the
    float32 input of every protected site of its forward, in call order
    (read out of the compiled step by ``jax.debug.callback``).
    {case: (state, metrics, site inputs)} as numpy."""
    jm, state, toks = _reference()
    opt = jadamw.AdamWConfig(**OPT)
    batch = {"tokens": jnp.asarray(toks)}
    out = {}
    real = japi.protect_linear
    for case, kw, counter in (
            ("clean", {}, 0),
            ("fat", dict(FAT, ft_key=jax.random.PRNGKey(17)), FAT_COUNTER)):
        xs = []

        def recorded(key, x, *a, **k):
            jax.debug.callback(lambda v: xs.append(np.array(v)), x,
                               ordered=True)
            return real(key, x, *a, **k)
        _, step = jmake_train_step(jm, opt, donate=False, **kw)
        s = dict(state, step=jnp.asarray(counter, jnp.int32))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(japi, "protect_linear", recorded)
            new, metrics = jax.block_until_ready(step(s, batch))
        out[case] = (*jax.tree.map(np.asarray, (new, metrics)), xs)
    return out


def _port_step(case, model=None):
    model = model or tiny_model(grad_accum=2 if case == "accum" else 1)
    kw = (dict(FAT, ft_key=prng.PRNGKey(17), ft_backend="fused")
          if case == "fat" else {})
    step = make_train_step(model, AdamWConfig(**OPT), **kw)
    counter = FAT_COUNTER if case == "fat" else 0
    return step(_port_state(counter), _batch())


def _site_int8(x):
    """(int8 operand, x / scale) of a site's float32 input."""
    xt = torch.from_numpy(np.array(x))
    q, scale = Q.quantize(xt)
    return q.numpy(), (xt / scale).numpy()


def _close(want, got, rtol, what):
    scale = max(np.abs(w).max() for w in jax.tree.leaves(want))
    for (name, g), w in zip(items(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=rtol * scale,
                                   err_msg=f"{what} {name}")


# -------------------------------------------------------------- the data --
def test_lm_stream_bitwise():
    """lm_batch over steps and process slices, make_batch, and LMIterator
    (next, state, restore) give the reference's tokens bit for bit."""
    cfg = jget_config("h2o-danube-1.8b", reduced=True)
    d = tdata.DataConfig(seed=5, noise=0.2)
    jd = jdata.DataConfig(seed=5, noise=0.2)
    for step, pi, pc in ((0, 0, 1), (7, 0, 1), (3, 1, 2)):
        want = np.asarray(jdata.lm_batch(jd, cfg.vocab, 4 * pc, 40, step, pi,
                                         pc))
        got = tdata.lm_batch(d, cfg.vocab, 4 * pc, 40, step, pi, pc, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    shape = JShape("tiny", "train", 40, 4)
    it = tdata.LMIterator(cfg, shape, start_step=2, device="cpu")
    for step in (2, 3):
        want = jdata.make_batch(cfg, shape, step)
        np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
    assert it.state() == {"step": 4}
    it.restore({"step": 9})
    np.testing.assert_array_equal(
        next(it)["tokens"].numpy(),
        np.asarray(jdata.make_batch(cfg, shape, 9)["tokens"]))
    with pytest.raises(ValueError):
        tdata.lm_batch(d, cfg.vocab, 5, 8, 0, 0, 2, "cpu")


# ------------------------------------------------------------ the optimizer --
def test_lr_schedule_equals_reference():
    cfg = AdamWConfig(warmup_steps=10, decay_steps=100)
    jcfg = jadamw.AdamWConfig(warmup_steps=10, decay_steps=100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 500):
        want = np.float32(jadamw.lr_at(jcfg, s))
        got = adamw.lr_at(cfg, torch.tensor(s, dtype=torch.int32))
        np.testing.assert_allclose(got.item(), want, rtol=ADAM_RTOL)


def test_adamw_update_equals_reference():
    """Two updates of a tree with 2-D and 1-D leaves (weight decay on the
    2-D ones only), gradients large enough to be clipped, bf16 moments on a
    second config: every leaf within ADAM_RTOL of its largest; and the
    in-place form (the donating train step's) bitwise the copying one."""
    rng = np.random.default_rng(4)
    shapes = {"a": {"w": (6, 5), "b": (5,)}, "c": (3, 4)}

    def tree(scale):
        def one(s):
            return (scale * rng.standard_normal(s)).astype(np.float32)
        return {"a": {k: one(v) for k, v in shapes["a"].items()},
                "c": one(shapes["c"])}
    params, g1, g2 = tree(1.0), tree(3.0), tree(0.5)
    for dt in ("float32", "bfloat16"):
        cfg, jcfg = AdamWConfig(dtype=dt), jadamw.AdamWConfig(dtype=dt)
        jp, jo = jax.tree.map(jnp.asarray, params), None
        tp = jax.tree.map(torch.from_numpy, params)
        jo = jadamw.init_opt_state(jp, jcfg)
        to = adamw.init_opt_state(tp, cfg)
        ip, io = tree_map(torch.clone, tp), tree_map(torch.clone, to)
        for g in (g1, g2):
            jp, jo, jm = jadamw.adamw_update(
                jax.tree.map(jnp.asarray, g), jo, jp, jcfg)
            tp, to, tm = adamw.adamw_update(
                jax.tree.map(torch.from_numpy, g), to, tp, cfg)
            old = leaves({"p": ip, "m": io["m"], "v": io["v"]})
            ip, io, _ = adamw.adamw_update(
                jax.tree.map(torch.from_numpy, g), io, ip, cfg, inplace=True)
            assert all(a is b for a, b in zip(
                leaves({"p": ip, "m": io["m"], "v": io["v"]}), old))
            for a, b in zip(leaves({"p": tp, "o": to}),
                            leaves({"p": ip, "o": io})):
                assert torch.equal(a, b)
            np.testing.assert_allclose(tm["grad_norm"].item(),
                                       float(jm["grad_norm"]),
                                       rtol=ADAM_RTOL)
            for want, got in ((jp, tp), (jo["m"], to["m"]),
                              (jo["v"], to["v"])):
                _close(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                    want),
                       jax.tree.map(lambda t: t.to(torch.float32), got),
                       ADAM_RTOL if dt == "float32" else 1e-2, dt)
        assert int(to["step"]) == 2


# ------------------------------------------------------------ the steps ---
def test_clean_step_equals_reference(ref_steps):
    (want, wmet, _), (got, gmet) = ref_steps["clean"], _port_step("clean")
    np.testing.assert_allclose(gmet["loss"].item(), float(wmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(gmet["grad_norm"].item(),
                               float(wmet["grad_norm"]), rtol=GRAD_RTOL)
    for part in ("m", "v"):
        _close(want[part], got[part], GRAD_RTOL, part)
    _close(want["params"], got["params"], PARAM_ATOL / max(
        np.abs(w).max() for w in jax.tree.leaves(want["params"])), "params")
    assert int(got["step"]) == int(want["step"]) == 1


def test_fat_step_equals_reference(ref_steps, monkeypatch):
    """The FAT step (crt1, BER 3e-3 mid-ramp, step counter 3).  Its
    faulty forward: the sites' int8 operands equal the jitted reference's
    up to the first that differs, l1/attn/wo (site 10 of 14), and there in
    one element, whose x / scale sits within TIE_ATOL of a .5 rounding tie
    (ROADMAP.md §C: the jitted reference rounds 10.5 there, and its
    op-by-op run, as the port, 10.500003; the port's operands equal the
    op-by-op run's at every site); the sites after it see that operand's
    consequences.  The backward's recompute gives the forward's operands
    again.  The loss
    within LOSS_RTOL, the BER and counter equal; one operand one step
    apart moves gradients by ~0.7% of the largest, so the moments and
    parameters are held within FAT_RTOL of their largest."""
    from repro_torch.ft import api as tapi
    want, wmet, wxs = ref_steps["fat"]
    xs, real = [], tapi.protect_linear

    def recorded(key, x, *a, **kw):
        xs.append(x.detach().numpy().copy())
        return real(key, x, *a, **kw)
    monkeypatch.setattr(tapi, "protect_linear", recorded)
    got, gmet = _port_step("fat")
    n = len(wxs)
    assert n == 14 and len(xs) == 2 * n      # the forward, then the
    again = xs[n + 7:] + xs[n:n + 7]         # backward's recompute, l1 first
    first = None
    for i, (w, x, x2) in enumerate(zip(wxs, xs[:n], again)):
        np.testing.assert_array_equal(x2, x)
        (qw, rw), (qx, _) = _site_int8(w), _site_int8(x)
        apart = qw != qx
        if first is None and apart.any():
            first = i
            assert apart.sum() == 1, i
            assert (np.abs(np.abs(rw[apart]) % 1 - 0.5) < TIE_ATOL).all(), i
    assert first in (None, 10)
    np.testing.assert_allclose(gmet["loss"].item(), float(wmet["loss"]),
                               rtol=LOSS_RTOL)
    for part in ("m", "v", "params"):
        _close(want[part], got[part], FAT_RTOL, part)
    assert int(got["step"]) == int(want["step"]) == FAT_COUNTER + 1
    assert gmet["fat_ber"].item() == float(wmet["fat_ber"])
    assert gmet["fat_ber"].item() == np.float32(FAT["ft_ber"]) / 2


def test_fat_step_differs_from_clean(ref_steps):
    """The FAT step's faults moved the loss and the gradients by far more
    than the bounds above: the FAT check can fail."""
    fat, clean = ref_steps["fat"], ref_steps["clean"]
    assert abs(float(fat[1]["loss"]) - float(clean[1]["loss"])) \
        > 100 * LOSS_RTOL * float(clean[1]["loss"])
    d = max(np.abs(a - b).max() for a, b in zip(
        jax.tree.leaves(fat[0]["m"]), jax.tree.leaves(clean[0]["m"])))
    scale = max(np.abs(a).max() for a in jax.tree.leaves(clean[0]["m"]))
    assert d > 10 * FAT_RTOL * scale


def test_grad_accum_close_to_one_batch(ref_steps):
    """tests/test_train.py's bounds: the port's grad_accum=2 step against
    the reference's one-batch step and against its own (the loss within
    0.05, the parameters within 5e-2)."""
    want, wmet, _ = ref_steps["clean"]
    for s1, m1 in (_port_step("clean"), (
            tree_map(lambda a: torch.from_numpy(a.copy()), want),
            {"loss": torch.tensor(float(
                wmet["loss"]))})):
        s2, m2 = _port_step("accum")
        assert abs(m1["loss"].item() - m2["loss"].item()) < 0.05
        assert max(float((a - b).abs().max()) for a, b in zip(
            leaves(s1["params"]), leaves(s2["params"]))) < 5e-2


def test_remat_block_equals_none_bitwise():
    """The FAT step with every layer recomputed in the backward pass gives
    the step without recompute bit for bit: the recompute draws the same
    keys, so its faulty activations are the forward's."""
    (a, ma) = _port_step("fat", tiny_model(remat="block"))
    (b, mb) = _port_step("fat", tiny_model(remat="none"))
    assert ma["loss"].item() == mb["loss"].item()
    for (name, x), (_, y) in zip(items(a), items(b)):
        assert torch.equal(x, y), name


def test_donated_step_equals_copying_step():
    """make_train_step(donate=True), the default, updates the state's
    parameters and moments in place; donate=False returns new tensors and
    leaves its input as it was; both give the same state bitwise."""
    model = tiny_model()
    out = {}
    for donate in (True, False):
        state = _port_state()
        before = tree_map(torch.clone, state)
        new, _ = make_train_step(model, AdamWConfig(**OPT),
                                 donate=donate)(state, _batch())
        same = [a is b for part in ("params", "m", "v")
                for a, b in zip(leaves(new[part]), leaves(state[part]))]
        assert all(same) if donate else not any(same)
        if not donate:
            for (name, a), (_, b) in zip(items(state), items(before)):
                assert torch.equal(a, b), name
        out[donate] = new
    for (name, a), (_, b) in zip(items(out[True]), items(out[False])):
        assert torch.equal(a, b), name


def test_microbatches_draw_their_own_keys(monkeypatch):
    """Under grad_accum=2, microbatch i's fault context carries
    fold_stream(fold_stream(root, step), i)."""
    import repro_torch.models.common as common
    from repro_torch.core.faults import fold_stream
    seen = []

    class Recording(common.FTCtx):
        def __init__(self, ft, key, *a, **kw):
            seen.append(key.clone())
            super().__init__(ft, key, *a, **kw)
    monkeypatch.setattr(common, "FTCtx", Recording)
    model = tiny_model(grad_accum=2)
    step = make_train_step(model, AdamWConfig(**OPT), policy="crt1",
                           ft_key=prng.PRNGKey(17), ft_backend="fused")
    step(_port_state(5), _batch())
    k_step = fold_stream(prng.PRNGKey(17), 5)
    assert len(seen) == 2
    for i, k in enumerate(seen):
        assert torch.equal(k, fold_stream(k_step, i))


def test_step_builders_and_meshes():
    """make_prefill_step and make_decode_step run the model; on the
    one-rank CPU mesh (make_local_mesh) the builders' mesh paths give the
    meshless results bitwise: prefill, decode and a train step from the
    state's shards (the 4-rank gloo mesh: tests/test_torch_sharded.py)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import shard_state, state_shardings, unshard_state
    model = tiny_model()
    params = _port_state()["params"]
    caches, logits = make_prefill_step(model)(params, _batch())
    want_c, want_l = model.prefill(params, _batch())
    assert torch.equal(logits, want_l)
    tok = logits.argmax(-1)
    _, l2 = make_decode_step(model)(params, caches, tok, BATCH["S"])
    assert l2.shape == logits.shape
    mesh = make_local_mesh("cpu")
    try:
        from repro_torch.parallel import sharding as S
        local = S.distribute(params, S.param_shardings(params, mesh,
                                                       no_fsdp=True), mesh)
        mc, ml = make_prefill_step(model, mesh=mesh)(local, _batch())
        assert torch.equal(ml, logits)
        _, ml2 = make_decode_step(model, mesh=mesh)(local, mc, tok,
                                                    BATCH["S"])
        assert torch.equal(ml2, l2)
        state = _port_state()
        specs = state_shardings(state, mesh)
        want, wm = make_train_step(model, AdamWConfig(**OPT), donate=False)(
            _port_state(), _batch())
        got, gm = make_train_step(model, AdamWConfig(**OPT), mesh=mesh)(
            shard_state(state, mesh), _batch())
        got = unshard_state(got, specs, mesh)
        assert float(gm["loss"]) == float(wm["loss"])
        for a, b in zip(leaves(got), leaves(want)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ checkpoints --
def state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4)},
            "m": {"w": torch.zeros((3, 4))},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    C.save(d, state(), 7, data_state={"step": 7})
    like = tree_map(lambda t: t.to("meta"), state())
    s, step, ds = C.restore(d, like, device="cpu")
    assert step == 7 and ds == {"step": 7}
    np.testing.assert_array_equal(s["params"]["w"].numpy(),
                                  np.arange(12.0).reshape(3, 4))
    assert s["step"].dtype == torch.int32 and int(s["step"]) == 7


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = str(tmp_path / "ck")
    C.save(d, state(), 5)
    os.remove(os.path.join(d, "step_5.done"))  # a crash mid-commit
    s, step, _ = C.restore(d, state(), device="cpu")
    assert s is None and step == -1


def test_latest_wins_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    for i in (1, 2, 3, 4, 5):
        C.save(d, state(), i, keep=3)
    assert C.available_steps(d) == [3, 4, 5]
    _, step, _ = C.restore(d, state(), device="cpu")
    assert step == 5


def test_async_save(tmp_path):
    d = str(tmp_path / "ck")
    t = C.save(d, state(), 9, async_write=True)
    t.join()
    assert C.available_steps(d) == [9]


def _crashing_savez(monkeypatch):
    def boom(*a, **kw):
        raise IOError("disk died mid-write")
    monkeypatch.setattr(C.np, "savez", boom)


def test_sync_crash_mid_save_keeps_previous(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    C.save(d, state(), 1)
    _crashing_savez(monkeypatch)
    with pytest.raises(IOError):
        C.save(d, state(), 2)
    assert C.available_steps(d) == [1]
    s, step, _ = C.restore(d, state(), device="cpu")
    assert step == 1 and s is not None


def test_async_crash_raises_at_join_and_keeps_previous(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    C.save(d, state(), 3)
    _crashing_savez(monkeypatch)
    w = C.save(d, state(), 4, async_write=True)
    with pytest.raises(IOError):
        w.join()
    assert not w.is_alive()
    assert C.available_steps(d) == [3]
    _, step, _ = C.restore(d, state(), device="cpu")
    assert step == 3


def test_gc_never_deletes_newest_committed(tmp_path):
    d = str(tmp_path / "ck")
    for i in (1, 2, 3, 4):
        C.save(d, state(), i, keep=1)
        assert C.available_steps(d) == [i]


def test_gc_keep_zero_keeps_all(tmp_path):
    d = str(tmp_path / "ck")
    for i in (1, 2, 3, 4, 5):
        C.save(d, state(), i, keep=0)
    assert C.available_steps(d) == [1, 2, 3, 4, 5]


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A train state with bf16 parameters and float32 moments, written by
    the reference, restores into the port's state by name, bitwise (bf16
    as its 2 raw bytes); the port's file holds the same names and bytes,
    and a float32 state the port wrote restores into the reference's."""
    jm = jbuild(jget_config("h2o-danube-1.8b", reduced=True), JRun())
    js = jinit_state(jm, jax.random.PRNGKey(2), jadamw.AdamWConfig())
    js = dict(js, step=jnp.asarray(11, jnp.int32))
    JC.save(str(tmp_path / "jax"), js, 11, data_state={"step": 11})
    model = build(get_config("h2o-danube-1.8b", reduced=True), RunConfig())
    like = init_state(model, torch.Generator(), AdamWConfig(), "meta")
    got, step, ds = C.restore(str(tmp_path / "jax"), like, device="cpu")
    assert step == 11 and ds == {"step": 11}
    want = train_state_from_jax(jax.tree.map(np.asarray, js), jm.cfg, "cpu")
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["m"]["embed"].dtype == torch.float32
    for (name, g), (_, w) in zip(items(got), items(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    C.save(str(tmp_path / "port"), got, 11, data_state={"step": 11})
    zj = np.load(str(tmp_path / "jax" / "step_11" / "arrays.npz"))
    zt = np.load(str(tmp_path / "port" / "step_11" / "arrays.npz"))
    assert sorted(zj.files) == sorted(zt.files)
    for name in zj.files:
        assert zj[name].tobytes() == zt[name].tobytes(), name
    f32 = _port_state(4)
    C.save(str(tmp_path / "f32"), f32, 4)
    back, step, _ = JC.restore(str(tmp_path / "f32"), _reference()[1])
    assert step == 4 and int(back["step"]) == 4
    for (name, t), a in zip(items(f32), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy(), name)


# ------------------------------------------------------------ the trainer --
def test_loss_decreases(tmp_path):
    tc = TrainerConfig(total_steps=60, ckpt_every=1000, log_every=1000,
                       ckpt_dir=str(tmp_path / "ck"))
    tr = Trainer(tiny_model(), ShapeConfig("tiny", "train", 64, 16),
                 AdamWConfig(lr=1e-2, warmup_steps=5, decay_steps=60), tc,
                 device="cpu")
    tr.run()
    first = np.mean([r["loss"] for r in tr.metrics_log[:5]])
    last = np.mean([r["loss"] for r in tr.metrics_log[-5:]])
    assert last < first - 0.4, (first, last)


FAT_KW = dict(fat_policy="cl", fat_ber=1e-3, fat_ramp=6, fat_seed=17)
FAT_SHAPE = ShapeConfig("tiny", "train", 32, 4)


@pytest.mark.parametrize("fat", (False, True), ids=("clean", "fat"))
def test_restart_bit_exact(tmp_path, fat):
    """Interrupt at 4, resume in a new Trainer to 8 == 8 uninterrupted steps,
    bit for bit: the whole state, and under FAT (tests/test_train.py's
    one-layer model, cl ramping to 1e-3) every resumed step's loss and BER,
    the resumed run on step 5's keys (not a replay of step 1's)."""
    kw = FAT_KW if fat else {}
    # under FAT the one-layer model without recompute: its cost is the
    # draws, and test_remat_block_equals_none_bitwise holds the recompute
    model = tiny_model(n_layers=1, remat="none") if fat else tiny_model()
    shape = FAT_SHAPE if fat else SHAPE

    def trainer(sub, total, every):
        tc = TrainerConfig(total_steps=total, ckpt_every=every,
                           log_every=1000, ckpt_dir=str(tmp_path / sub),
                           ckpt_async=False, **kw)
        return Trainer(model, shape, AdamWConfig(**OPT), tc, device="cpu")
    t1 = trainer("a", 8, 100)
    s1, _ = t1.run()
    trainer("b", 4, 4).run()
    t3 = trainer("b", 8, 100)
    s3, step3 = t3.init_or_restore()
    assert step3 == 4
    s3, _ = t3.run(s3, step3)
    for (name, a), (_, b) in zip(items(s1), items(s3)):
        assert torch.equal(a, b), name
    if fat:
        bers = [r["fat_ber"] for r in t1.metrics_log]
        assert bers == sorted(bers)
        assert bers[0] == 0.0 and bers[-1] == pytest.approx(1e-3)
        cont = {r["step"]: r for r in t1.metrics_log}
        for r in t3.metrics_log:
            assert r["loss"] == cont[r["step"]]["loss"], r["step"]
            assert r["fat_ber"] == cont[r["step"]]["fat_ber"], r["step"]
        assert t3.metrics_log[0]["step"] == 5
        assert t3.metrics_log[0]["loss"] != t1.metrics_log[0]["loss"]


def _step_clock(monkeypatch, seconds):
    """The Trainer's clock, advanced only by the delay hook: step ``s``
    lasts ``seconds(s)``, whatever the machine's load does to the real
    step (the straggler tests check the Trainer's bookkeeping, which a
    loaded CPU would otherwise decide)."""
    now = [0.0]
    monkeypatch.setattr(T, "time", types.SimpleNamespace(
        monotonic=lambda: now[0]))

    def delay(step):
        now[0] += seconds(step)
    return delay


def test_straggler_detection_and_ckpt(tmp_path, monkeypatch):
    slow_steps = {12, 13, 14}
    delay = _step_clock(monkeypatch,
                        lambda s: 1.0 if s in slow_steps else 2 ** -5)
    tc = TrainerConfig(total_steps=16, ckpt_every=1000, log_every=1000,
                       ckpt_dir=str(tmp_path / "s"), ckpt_async=False,
                       straggler_factor=3.0, straggler_patience=3)
    tr = Trainer(tiny_model(), SHAPE, AdamWConfig(), tc, delay_hook=delay,
                 device="cpu")
    tr.run()
    assert tr.straggler_events >= 2
    assert C.available_steps(str(tmp_path / "s"))  # emergency checkpoint


def test_running_median_tracks_sliding_window():
    xs = list(np.random.default_rng(0).uniform(0.01, 2.0, size=300))
    m = _RunningMedian(16)
    for i, x in enumerate(xs):
        m.add(x)
        window = xs[max(0, i - 15):i + 1]
        assert len(m) == len(window)
        assert m.median == sorted(window)[len(window) // 2]


def test_first_step_excluded_from_straggler_window(tmp_path, monkeypatch):
    delay = _step_clock(monkeypatch, lambda s: 1.0 if s == 0 else 2 ** -5)
    tc = TrainerConfig(total_steps=10, ckpt_every=1000, log_every=1000,
                       ckpt_dir=str(tmp_path / "w"), ckpt_async=False,
                       straggler_factor=3.0, straggler_window=8)
    tr = Trainer(tiny_model(), SHAPE, AdamWConfig(), tc, delay_hook=delay,
                 device="cpu")
    tr.run()
    assert tr.straggler_events == 0
    assert not tr.metrics_log[0]["straggler"]
    assert [r["sec"] for r in tr.metrics_log] == [1.0] + [2 ** -5] * 9


def test_async_ckpt_writers_never_interleave(tmp_path, monkeypatch):
    live = {"cur": 0, "max": 0}
    lock = threading.Lock()
    orig = C.np.savez

    def slow_savez(*a, **kw):
        with lock:
            live["cur"] += 1
            live["max"] = max(live["max"], live["cur"])
        time.sleep(0.05)
        try:
            return orig(*a, **kw)
        finally:
            with lock:
                live["cur"] -= 1
    tc = TrainerConfig(total_steps=6, ckpt_every=1, log_every=1000,
                       ckpt_dir=str(tmp_path / "q"), ckpt_async=True)
    tr = Trainer(tiny_model(), SHAPE, AdamWConfig(), tc, device="cpu")
    monkeypatch.setattr(C.np, "savez", slow_savez)
    tr.run()
    assert live["max"] == 1, live
    assert C.available_steps(str(tmp_path / "q"))[-1] == 6


def test_launch_train_smoke(tmp_path, capsys):
    """The launcher's --smoke on the CPU: the reduced config in bf16, its
    checkpoints written and restorable."""
    from repro_torch.launch import train as launch
    d = str(tmp_path / "ck")
    launch.main(["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "2",
                 "--ckpt", d, "--device", "cpu"])
    assert "finished at step 2" in capsys.readouterr().out
    assert C.available_steps(d) == [1, 2]
    model = build(get_config("h2o-danube-1.8b", reduced=True),
                  RunConfig(param_dtype="bfloat16"))
    like = init_state(model, torch.Generator(), AdamWConfig(), "meta")
    s, step, ds = C.restore(d, like, device="cpu")
    assert step == 2 and ds == {"step": 2} and int(s["step"]) == 2
    assert s["params"]["embed"].dtype == torch.bfloat16
