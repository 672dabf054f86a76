"""Training of the MoE, Mamba2-SSD, RG-LRU, encoder-decoder and
vision-frontend families in the port against the reference, at their
reduced sizes in float32 (qwen3-moe-235b-a22b, mamba2-2.7b,
recurrentgemma-9b, seamless-m4t-medium, paligemma-3b), the reference's
train state carried across by ``repro_torch.convert``.  The FAT steps
are held in tests/test_torch_family_fat.py, which imports this module's
helpers.

Held, with the tolerance stated at each test:
  * ``prng.uniform`` and ``prng.normal`` in bfloat16: bitwise jax's, on
    every one of the 128 values a bfloat16 uniform takes (through
    ``erf_inv``), on a (4, 64, 256) draw and on a key batch;
  * ``make_batch`` and ``LMIterator`` of seamless and paligemma: tokens,
    ``frames`` and ``patch_embeds`` bitwise the reference's in bfloat16
    (the default), over two steps and two processes; in float32 the tokens
    bitwise and the inputs within ``prng.normal``'s 3 ulps;
  * each family's clean train step against the reference's jitted
    ``make_train_step`` from the same state, as
    tests/test_torch_train.py holds danube's: the loss within LOSS_RTOL,
    ``grad_norm``, the moments within GRAD_RTOL of their largest, the
    parameters within PARAM_ATOL, the step counter equal;
  * qwen3-moe's step with its ``RUN``'s ``grad_accum=4`` and bfloat16
    moments (the MoE's capacity follows the microbatch) against the
    reference's accumulated step;
  * the Trainer of seamless and of paligemma: its batches (bfloat16
    ``frames`` / ``patch_embeds``) equal the reference ``LMIterator``'s,
    and a restart, clean and under FAT, continues bitwise, port against
    port;
  * ``launch/train.py --smoke --device cpu`` trains each family.

Each reference train step compiles once per module.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core.faults  # noqa: F401  (partitionable threefry)
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jdata
from repro.ft import api as japi
from repro.models import build as jbuild
from repro.optim import adamw as jadamw
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import train_state_from_jax
from repro_torch.core import prng
from repro_torch.data import pipeline as tdata
from repro_torch.models import build
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.train import checkpoint as C
from repro_torch.tree import items

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

FAMILIES = ("mamba2-2.7b", "recurrentgemma-9b", "qwen3-moe-235b-a22b",
            "seamless-m4t-medium", "paligemma-3b")
NEW_INPUTS = ("seamless-m4t-medium", "paligemma-3b")
F32 = dict(param_dtype="float32", compute_dtype="float32")
# tests/test_torch_train.py's bounds: the loss (float32 sums in each
# framework's order), the gradients read from the moments against their
# largest, the parameters after one AdamW step of lr 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-6
OPT = dict(lr=1e-3)
B, S = 4, 32


def _bits16(a) -> np.ndarray:
    """The 16-bit patterns of a bfloat16 array (jax's or the port's)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


# ----------------------------------------------------------- the draws ---
def test_bf16_normal_all_128_uniform_values():
    """A bfloat16 uniform in [nextafter(-1, 0), 1) takes 128 values; each,
    through erf_inv and the product with sqrt(2), gives jax's bits."""
    lo = jnp.bfloat16(-0.99609375)
    u = jnp.maximum(lo, jnp.arange(128).astype(jnp.bfloat16)
                    / jnp.bfloat16(128) * jnp.bfloat16(2) + lo)
    want = jax.jit(lambda u: jax.lax.mul(np.array(np.sqrt(2), jnp.bfloat16),
                                         jax.lax.erf_inv(u)))(u)
    assert len(np.unique(np.asarray(u))) == 128
    ut = torch.from_numpy(_bits16(u).copy()).view(torch.bfloat16)
    got = prng._normal_from_uniform(ut)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits16(got), _bits16(want))


@pytest.mark.parametrize("seed", (0, 3, 2 ** 31 + 5))
def test_bf16_draws_bitwise(seed):
    """normal and uniform (its default range, normal's and another) in
    bfloat16 on a (4, 64, 256) draw: jax's bits, and not the float32 draw
    rounded."""
    k, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    shape = (4, 64, 256)
    want = jax.random.normal(k, shape, jnp.bfloat16)
    got = prng.normal(tk, shape, torch.bfloat16)
    np.testing.assert_array_equal(_bits16(got), _bits16(want))
    rounded = prng.normal(tk, shape).to(torch.bfloat16)
    assert (_bits16(rounded) != _bits16(want)).mean() > 0.5
    for lo, hi in ((0., 1.), (-0.99609375, 1.), (-2., 3.)):
        want = jax.random.uniform(k, shape, jnp.bfloat16, lo, hi)
        got = prng.uniform(tk, shape, lo, hi, torch.bfloat16)
        np.testing.assert_array_equal(_bits16(got), _bits16(want))


def test_bf16_normal_key_batch_is_vmap():
    ks = jax.random.split(jax.random.PRNGKey(9), 5)
    want = jax.vmap(lambda k: jax.random.normal(k, (3, 40), jnp.bfloat16))(ks)
    got = prng.normal(prng.as_key(np.asarray(ks)), (3, 40), torch.bfloat16)
    np.testing.assert_array_equal(_bits16(got), _bits16(want))


# ------------------------------------------------------------ the data ---
def _cmp_batch(got, want):
    """Tokens and bfloat16 inputs bitwise; float32 inputs within
    ``prng.normal``'s float32 bound of 3 ulps (its ``erfinv`` takes each
    framework's float32 ``log1p``, which part in the last place)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(_bits16(g), _bits16(w), name)
        elif w.dtype == jnp.float32:
            assert g.dtype == torch.float32, name
            np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), 3)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
@pytest.mark.parametrize("arch", NEW_INPUTS)
def test_make_batch_equals_reference(arch, dtype):
    """Tokens (S - n_frontend_tokens of them for the vision family),
    frames and patch embeddings: the reference's bits (float32 inputs
    within 3 ulps), over two steps and both slices of two processes."""
    cfg = tconfigs.get_config(arch, reduced=True)
    jcfg = jconfigs.get_config(arch, reduced=True)
    shape = JShape("tiny", "train", 24, 4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for step in (0, 5):
        for pi, pc in ((0, 1), (0, 2), (1, 2)):
            want = jdata.make_batch(jcfg, shape, step, process_index=pi,
                                    process_count=pc, compute_dtype=jdt)
            got = tdata.make_batch(cfg, shape, step, process_index=pi,
                                   process_count=pc, compute_dtype=tdt,
                                   device="cpu")
            _cmp_batch(got, want)
    n_front = 8 if arch == "paligemma-3b" else 0
    assert got["tokens"].shape == (2, 24 - n_front)


@pytest.mark.parametrize("arch", NEW_INPUTS)
def test_lm_iterator_carries_inputs(arch):
    """LMIterator (next, state, restore) yields the reference iterator's
    batches, bfloat16 frames and patch embeddings included."""
    cfg = tconfigs.get_config(arch, reduced=True)
    jcfg = jconfigs.get_config(arch, reduced=True)
    shape = JShape("tiny", "train", 16, 2)
    it = tdata.LMIterator(cfg, shape, start_step=3, device="cpu")
    jit = jdata.LMIterator(jcfg, shape, start_step=3)
    for _ in range(2):
        _cmp_batch(next(it), next(jit))
    assert it.state() == jit.state() == {"step": 5}
    it.restore({"step": 11})
    jit.restore({"step": 11})
    b = next(it)
    _cmp_batch(b, next(jit))
    assert (b.get("frames", b.get("patch_embeds"))).dtype == torch.bfloat16


# ------------------------------------------------------------ the steps ---
def _cfgs(arch, n_layers=None, n_enc_layers=None):
    """(reference config, port config) at the reduced size, cut to
    ``n_layers`` (and ``n_enc_layers``) where given."""
    over = {k: v for k, v in (("n_layers", n_layers),
                              ("n_enc_layers", n_enc_layers)) if v}
    return (dataclasses.replace(jconfigs.get_config(arch, reduced=True),
                                **over),
            dataclasses.replace(tconfigs.get_config(arch, reduced=True),
                                **over))


def np_batch(cfg, seed=1):
    """Numpy float32 inputs of a (B, S) step: S - n_front tokens behind
    n_front patch embeddings (vision), or S tokens and S frames."""
    rng = np.random.default_rng(seed)
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S - n_front)
                                ).astype(np.int32)}
    if cfg.frontend == "vision":
        b["patch_embeds"] = rng.standard_normal(
            (B, n_front, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)
                                          ).astype(np.float32)
    return b


def torch_batch(b):
    return {k: torch.from_numpy(v.copy()).long() if k == "tokens"
            else torch.from_numpy(v.copy()) for k, v in b.items()}


@functools.cache
def reference(arch, cut=(), grad_accum=1, adam_dtype="float32"):
    """(jax model, its initial state (numpy), the numpy batch) at the
    reduced size in float32; ``cut``: ((field, value), ...) config
    overrides."""
    jcfg, _ = _cfgs(arch, **dict(cut))
    jm = jbuild(jcfg, JRun(**F32, grad_accum=grad_accum))
    state = jinit_state(jm, jax.random.PRNGKey(0),
                        jadamw.AdamWConfig(**OPT, dtype=adam_dtype))
    return jm, jax.tree.map(np.asarray, state), np_batch(jcfg)


def run_reference(jm, state, batch, counter=0, record=None, **fat):
    """The reference's jitted train step from ``state`` at step counter
    ``counter``, and, where ``record`` is a list, the float32 input of
    every protected site of its forward, in call order (read out of the
    compiled step by ``jax.debug.callback``).  (state, metrics) as numpy."""
    opt = jadamw.AdamWConfig(**OPT, dtype=_adam_dtype(state))
    real = japi.protect_linear

    def recorded(key, x, *a, **k):
        jax.debug.callback(lambda v: record.append(np.array(v)), x,
                           ordered=True)
        return real(key, x, *a, **k)
    _, step = jmake_train_step(jm, opt, donate=False, **fat)
    s = dict(jax.tree.map(jnp.asarray, state),
             step=jnp.asarray(counter, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        if record is not None:
            mp.setattr(japi, "protect_linear", recorded)
        out = jax.block_until_ready(step(s, jb))
    return jax.tree.map(np.asarray, out)


def _adam_dtype(state):
    m = jax.tree.leaves(state["m"])[0]
    return "bfloat16" if m.dtype == jnp.bfloat16 else "float32"


def port_step(arch, state, batch, counter=0, cut=(), grad_accum=1, **fat):
    """The port's train step on the reference's state and batch."""
    _, tcfg = _cfgs(arch, **dict(cut))
    model = build(tcfg, RunConfig(**F32, grad_accum=grad_accum))
    ts = train_state_from_jax(state, tcfg, device="cpu")
    ts["step"] = torch.tensor(counter, dtype=torch.int32)
    step = make_train_step(model, AdamWConfig(**OPT,
                                              dtype=_adam_dtype(state)),
                           **fat)
    return step(ts, torch_batch(batch))


def as_f32(t):
    return t.to(torch.float32).numpy()


def close(want, got, rtol, what, ulps=0):
    """Every leaf of ``got`` within ``rtol`` of the largest of ``want``,
    plus ``ulps`` bfloat16 ulps of each element (a float32 difference
    within the bound moves a bfloat16 rounding by one)."""
    wl = [np.asarray(w, np.float32) for w in jax.tree.leaves(want)]
    scale = max(np.abs(w).max() for w in wl)
    for (name, g), w in zip(items(got), wl):
        atol = rtol * scale + ulps * np.abs(w) * 2.0 ** -7
        np.testing.assert_array_less(np.abs(as_f32(g) - w), atol + 1e-30,
                                     err_msg=f"{what} {name}")


def hold_clean(want, wmet, got, gmet, ulps=0):
    np.testing.assert_allclose(gmet["loss"].item(), float(wmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(gmet["grad_norm"].item(),
                               float(wmet["grad_norm"]), rtol=GRAD_RTOL)
    for part in ("m", "v"):
        close(want[part], got[part], GRAD_RTOL, part, ulps)
    close(want["params"], got["params"], PARAM_ATOL / max(
        np.abs(w).max() for w in jax.tree.leaves(want["params"])), "params")
    assert int(got["step"]) == int(want["step"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_clean_step_equals_reference(arch):
    """One clean step from the reference's initial state: loss,
    grad_norm, moments, parameters and counter (the bounds above)."""
    jm, state, batch = reference(arch)
    want, wmet = run_reference(jm, state, batch)
    got, gmet = port_step(arch, state, batch)
    hold_clean(want, wmet, got, gmet)
    assert int(got["step"]) == 1


def test_moe_accumulated_step_equals_reference():
    """qwen3-moe with its RUN's grad_accum=4 and bfloat16 moments: four
    microbatches of one row (the MoE's capacity from a microbatch's 32
    tokens), against the reference's scanned accumulation.  The moments
    are bfloat16, so each is held within GRAD_RTOL of the largest plus one
    bfloat16 ulp of its own value."""
    arch = "qwen3-moe-235b-a22b"
    run = jconfigs.get_run_config(arch)
    assert (run.grad_accum, run.adam_dtype) == (4, "bfloat16")
    jm, state, batch = reference(arch, grad_accum=4, adam_dtype="bfloat16")
    want, wmet = run_reference(jm, state, batch)
    got, gmet = port_step(arch, state, batch, grad_accum=4)
    assert got["m"]["embed"].dtype == torch.bfloat16
    hold_clean(want, wmet, got, gmet, ulps=1)
    one, _ = run_reference(*reference(arch))
    d = max(np.abs(np.asarray(a, np.float32) - b).max() for a, b in zip(
        jax.tree.leaves(want["v"]), jax.tree.leaves(one["v"])))
    assert d > 10 * GRAD_RTOL * max(
        np.abs(np.asarray(a, np.float32)).max()
        for a in jax.tree.leaves(one["v"]))   # the accumulation shows


# ---------------------------------------------------------- the trainer --
FAT_KW = dict(fat_policy="crt1", fat_ber=6e-3, fat_ramp=4, fat_seed=17)


@pytest.mark.parametrize("fat", (False, True), ids=("clean", "fat"))
@pytest.mark.parametrize("arch", NEW_INPUTS)
def test_trainer_restart_bit_exact(tmp_path, arch, fat, monkeypatch):
    """The Trainer from LMIterator (bfloat16 frames / patch embeddings,
    each batch the reference iterator's): interrupted at step 2 and
    resumed in a new Trainer to step 4, it equals 4 uninterrupted steps
    bit for bit, the whole state, each step's loss and, under FAT (crt1
    ramping to 6e-3, seamless at one encoder and one decoder layer), its
    BER."""
    cut = dict(n_layers=1, n_enc_layers=1) if arch == NEW_INPUTS[0] else {}
    _, tcfg = _cfgs(arch, **(cut if fat else {}))
    model = build(tcfg, RunConfig(**F32))
    shape = ShapeConfig("tiny", "train", 16, 2)
    jit = jdata.LMIterator(jconfigs.get_config(arch, reduced=True), shape)
    seen = []
    real = tdata.LMIterator.__next__

    def recorded(self):
        b = real(self)
        seen.append((self.step - 1, b))
        return b
    monkeypatch.setattr(tdata.LMIterator, "__next__", recorded)

    def trainer(sub, total, every):
        tc = TrainerConfig(total_steps=total, ckpt_every=every,
                           log_every=1000, ckpt_dir=str(tmp_path / sub),
                           ckpt_async=False, **(FAT_KW if fat else {}))
        return Trainer(model, shape, AdamWConfig(**OPT), tc, device="cpu")
    t1 = trainer("a", 4, 100)
    s1, _ = t1.run()
    for i, (step, b) in enumerate(seen):
        assert step == i
        _cmp_batch(b, next(jit))
    trainer("b", 2, 2).run()
    assert C.available_steps(str(tmp_path / "b")) == [2]
    t3 = trainer("b", 4, 100)
    s3, step3 = t3.init_or_restore()
    assert step3 == 2
    s3, _ = t3.run(s3, step3)
    for (name, a), (_, b) in zip(items(s1), items(s3)):
        assert torch.equal(a, b), name
    cont = {r["step"]: r for r in t1.metrics_log}
    for r in t3.metrics_log:
        assert r["loss"] == cont[r["step"]]["loss"], r["step"]
        assert r.get("fat_ber") == cont[r["step"]].get("fat_ber")
    assert [r["step"] for r in t3.metrics_log] == [3, 4]
    if fat:
        assert t1.metrics_log[-1]["fat_ber"] == pytest.approx(4.5e-3)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_train_smoke(tmp_path, capsys, arch):
    """The launcher's --smoke on the CPU for each family: the reduced
    config in bf16, its RUN's grad_accum and Adam dtype, checkpoints
    written and restorable."""
    from repro_torch.launch import train as launch
    from repro_torch.train import init_state
    d = str(tmp_path / "ck")
    launch.main(["--arch", arch, "--smoke", "--steps", "1", "--ckpt", d,
                 "--device", "cpu"])
    assert "finished at step 1" in capsys.readouterr().out
    run = tconfigs.get_run_config(arch)
    model = build(tconfigs.get_config(arch, reduced=True), run)
    like = init_state(model, torch.Generator(), AdamWConfig(
        dtype=run.adam_dtype), "meta")
    s, step, ds = C.restore(d, like, device="cpu")
    assert step == 1 and ds == {"step": 1} and int(s["step"]) == 1
    assert s["m"]["embed"].dtype == getattr(torch, run.adam_dtype)
    assert all(torch.isfinite(t.float()).all() for _, t in items(s))


@pytest.mark.parametrize("arch", FAMILIES)
def test_checkpoint_of_reference_state_bitwise(tmp_path, arch):
    """A train state of each family in its RUN's dtypes (bf16 parameters;
    qwen3-moe's bf16 moments and expert stacks, seamless's encoder layers,
    the SSD and RG-LRU leaves), written by the reference, restores into
    the port's state by name, bitwise; the port writes the same names and
    bytes back, and restores its own file bitwise."""
    from repro.train import checkpoint as JC
    from repro_torch.train import init_state
    run = jconfigs.get_run_config(arch)
    jm = jbuild(jconfigs.get_config(arch, reduced=True), JRun())
    js = jinit_state(jm, jax.random.PRNGKey(2),
                     jadamw.AdamWConfig(dtype=run.adam_dtype))
    js = jax.tree.map(lambda a: a + jnp.asarray(0.25, a.dtype)
                      if a.dtype != jnp.int32 else a, js)  # nonzero moments
    js = dict(js, step=jnp.asarray(7, jnp.int32))
    JC.save(str(tmp_path / "jax"), js, 7, data_state={"step": 7})
    model = build(tconfigs.get_config(arch, reduced=True), RunConfig())
    like = init_state(model, torch.Generator(),
                      AdamWConfig(dtype=run.adam_dtype), "meta")
    got, step, ds = C.restore(str(tmp_path / "jax"), like, device="cpu")
    assert step == 7 and ds == {"step": 7}
    want = train_state_from_jax(jax.tree.map(np.asarray, js), model.cfg,
                                "cpu")
    assert [n for n, _ in items(got)] == [n for n, _ in items(want)]
    for (name, g), (_, w) in zip(items(got), items(want)):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert got["m"]["embed"].dtype == getattr(torch, run.adam_dtype)
    C.save(str(tmp_path / "port"), got, 7, data_state={"step": 7})
    zj = np.load(str(tmp_path / "jax" / "step_7" / "arrays.npz"))
    zt = np.load(str(tmp_path / "port" / "step_7" / "arrays.npz"))
    assert sorted(zj.files) == sorted(zt.files)
    for name in zj.files:
        assert zj[name].tobytes() == zt[name].tobytes(), name
    back, _, _ = C.restore(str(tmp_path / "port"), like, device="cpu")
    for (name, b), (_, g) in zip(items(back), items(got)):
        assert torch.equal(b, g), name
