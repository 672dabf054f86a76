"""The port's model and serving engine against the reference's
Engine(loop="python"), on reduced h2o-danube-1.8b (float32 on both sides,
the reference's parameters carried across by params_from_jax).

  * Prefill logits and two decode steps' logits (the second one wraps the
    rolling cache), clean and under cl with weight faults, are within TOL
    of the reference Engine's own prefill and decode executables.  Stated
    tolerance: |logit difference| <= 1e-4 (logits are O(3)).  The two
    frameworks round float32 ops differently (rsqrt, pow, exp and the order
    of matmul sums), which moves logits by about 1e-6; a wrong site key,
    cache slot or mask moves them by 1e-2 and more.
  * At temperature 0 the port emits the reference's tokens, with both of
    its ft backends, under crt3 and under cl with weight faults (the policy
    of the reference's own fused-vs-reference engine test).  Both faulty
    policies run the scanned layout (unroll=False, one set of site names
    for every layer), as full-width configs do (its reference executables
    also compile in a third less time than the unrolled ones with weight
    faults; tests/test_torch_scheduler.py holds the unrolled layout under
    faults), and crt3's prefill logits are held to TOL too.
    Both of the port's loops are held: "scan" (its default, as the
    reference's: one decode step run over static buffers, replayed as a
    CUDA graph on the card and eagerly here) with 2 host round trips, and
    "python" with 1 + n.  At temperature 0 the reference's own tests hold
    its scan's tokens equal to its python loop's (tests/test_serve_engine.py),
    so one reference run serves both of the port's loops.
  * The scan stays right over back-to-back generations that reuse its
    static buffers (equal and different prompt lengths, another batch, and
    on a config with global layers, another capacity).  Its step, and the
    Scheduler's, make no host sync and no host-to-device copy (what a CUDA
    graph cannot hold).
  * The key schedule (_call_key) is bitwise the reference's.
  * The pallas backend: under crt3 at BER 3e-3 with the truncation LSB
    ft_t=6, the port's Engine emits the reference Engine's tokens, with one
    int and with a {site: int} table, and its prefill logits are within
    TOL; ``linear`` reads a per-site table as the reference's does; a site
    without a t is refused, as under the reference's jit.

One reference Engine per policy and backend serves both the logits and the
tokens, so each one's prefill and decode compile once.
"""
import contextlib
import functools
import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs.h2o_danube_1_8b as JD
import repro_torch.configs.h2o_danube_1_8b as TD
from repro import ft as jft
from repro.configs.base import RunConfig as JRun
from repro.configs.base import reduce_config as jreduce
from repro.models import build as jbuild
from repro.models import common as jcommon
from repro.serve import engine as jengine
from repro_torch import ft as tft
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import reduce_config as treduce
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.models import build as tbuild
from repro_torch.models import common as tcommon
from repro_torch.models.common import FTCtx as TFTCtx
from repro_torch.models.transformer import layer_names
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
N_NEW = 5
PROMPT = 20            # longer than the reduced window (16): the cache rolls
TOL = 1e-4
N_NEW_PALLAS = 2       # its planes cover 128 padded rows: slow on the CPU
T_PALLAS = 6


# the policy's layout: the faulty ones on the scanned one, clean unrolled
UNROLL = {None: True, "cl": False, "crt3": False}


@functools.cache
def _models(unroll=True):
    """(jax model, jax params, port model, port params)."""
    jcfg = jreduce(JD.CONFIG, unroll=unroll)
    tcfg = treduce(TD.CONFIG, unroll=unroll)
    jm = jbuild(jcfg, JRun(**F32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg, TRun(**F32))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


@functools.cache
def _jax_engine(policy, weight_faults):
    jm, jp, _, _ = _models(UNROLL[policy])
    return jengine.Engine(
        jm, jp, cfg=jengine.ServeConfig(max_new_tokens=N_NEW, loop="python"),
        policy=None if policy is None else jft.get_policy(
            policy, ber=3e-3, weight_faults=weight_faults))


@functools.cache
def _jax_pallas_engine():
    jm, jp, _, _ = _models()
    return jengine.Engine(
        jm, jp, cfg=jengine.ServeConfig(max_new_tokens=N_NEW_PALLAS,
                                        loop="python"),
        policy=jft.get_policy("crt3", ber=3e-3, weight_faults=False),
        ft_backend="pallas", ft_t=T_PALLAS)


def _sites(cfg):
    return [f"{layer}/{site}" for layer in layer_names(cfg)
            for site in ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                         "mlp/wi", "mlp/wg", "mlp/wo")]


def _prompt():
    return np.random.default_rng(2).integers(0, JD.REDUCED.vocab,
                                             (2, PROMPT)).astype(np.int32)


def test_call_key_matches_reference():
    """Call-index folding, seed= and key= pins, in one call sequence."""
    jself = types.SimpleNamespace(cfg=jengine.ServeConfig(seed=7),
                                  _n_calls=0)
    tself = types.SimpleNamespace(cfg=tengine.ServeConfig(seed=7),
                                  _n_calls=0, device=torch.device("cpu"))
    for key, seed in ((None, None), (None, None), (None, 5),
                      (jax.random.PRNGKey(2**31 + 9), None), (None, None)):
        want = jengine.Engine._call_key(jself, key, seed)
        tkey = None if key is None else prng.as_key(np.asarray(key))
        got = tengine.Engine._call_key(tself, tkey, seed)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w),
                                          g.numpy().astype(np.uint32))
    assert tself._n_calls == jself._n_calls == 5


@pytest.mark.parametrize("policy", (None, "cl"))
def test_prefill_and_decode_logits(policy):
    """Clean, and under cl with weight faults as the engine runs it (no
    importance masks, so cl acts through its bit protection and Q_scale;
    tests/test_torch_model.py drives its DPPU through ``linear``)."""
    _, _, tm, tp = _models(UNROLL[policy])
    jeng = _jax_engine(policy, policy is not None)
    toks = _prompt()
    key = jax.random.PRNGKey(3)

    def tftc(k):
        if policy is None:
            return None
        return TFTCtx(tft.get_policy(policy, ber=3e-3, weight_faults=True),
                      prng.as_key(np.asarray(k)))
    jc, jl = jeng._prefill(jeng.params, {"tokens": jnp.asarray(toks)},
                           PROMPT + N_NEW, key)
    tc, tl = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        max_len=PROMPT + N_NEW, ftc=tftc(key))
    assert np.abs(np.asarray(jl) - tl.numpy()).max() <= TOL
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(2):
        k = jax.random.fold_in(key, step + 1)
        jc, jl = jeng._decode(jeng.params, jc, jnp.asarray(tok),
                              jnp.asarray(PROMPT + step, jnp.int32), k)
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(tok), PROMPT + step,
                                ftc=tftc(k))
        assert np.abs(np.asarray(jl) - tl.numpy()).max() <= TOL, step
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_scanned_prefill_logits():
    """crt3 on the scanned layout: every layer draws from the site names
    sb0/s0/..., in the port as in the reference."""
    _, _, tm, tp = _models(False)
    jeng = _jax_engine("crt3", False)
    toks, key = _prompt(), jax.random.PRNGKey(4)
    _, jl = jeng._prefill(jeng.params, {"tokens": jnp.asarray(toks)},
                          PROMPT + N_NEW, key)
    _, tl = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                       max_len=PROMPT + N_NEW, ftc=TFTCtx(
                           tft.get_policy("crt3", ber=3e-3,
                                          weight_faults=False),
                           prng.as_key(np.asarray(key))))
    assert np.abs(np.asarray(jl) - tl.numpy()).max() <= TOL


@functools.cache
def _jax_tokens(policy, weight_faults):
    return np.asarray(_jax_engine(policy, weight_faults).generate(
        {"tokens": jnp.asarray(_prompt())}, seed=0))


def _roundtrips(loop, n_new):
    return 2 if loop == "scan" else 1 + n_new


@pytest.mark.parametrize("loop", tengine.LOOPS)
@pytest.mark.parametrize("policy,weight_faults", (("crt3", False),
                                                  ("cl", True)))
def test_engine_tokens_match_reference(policy, weight_faults, loop):
    _, _, tm, tp = _models(UNROLL[policy])
    want = _jax_tokens(policy, weight_faults)
    for backend in ("reference", "fused"):
        teng = tengine.Engine(
            tm, tp, cfg=tengine.ServeConfig(max_new_tokens=N_NEW),
            policy=tft.get_policy(policy, ber=3e-3,
                                  weight_faults=weight_faults),
            ft_backend=backend, loop=loop)
        got = teng.generate({"tokens": torch.from_numpy(_prompt())}, seed=0)
        np.testing.assert_array_equal(got.numpy(), want, backend)
        assert teng.stats.roundtrips == _roundtrips(loop, N_NEW)
        assert teng.stats.tokens == want.size


def test_engine_refuses_what_is_not_ported():
    """The scan loop is the default and runs; an unknown loop raises; a
    prefill-only probe returns no tokens."""
    assert tengine.LOOPS == ("scan", "python")
    assert tengine.ServeConfig().loop == "scan"
    tm = tbuild(TD.REDUCED, TRun(**F32))
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="unknown loop"):
        tengine.Engine(tm, tp, loop="while")
    eng = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(max_new_tokens=3))
    assert eng.loop == "scan"
    out = eng.generate({"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert out.shape == (1, 3) and eng.stats.roundtrips == 2
    out = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(
        max_new_tokens=0)).generate({"tokens": torch.zeros(
            (1, 4), dtype=torch.long)})
    assert out.shape == (1, 0)


@pytest.mark.parametrize("pattern", (("L",), ("G", "L")))
def test_scan_back_to_back_generations(pattern):
    """One scan Engine serves prompts of 20, 6 and again 20 tokens, then
    another batch, each equal to a fresh python-loop Engine on it: the
    static buffers (caches, token, position, step index, keys) are loaded
    anew each time.  A new cache shape replaces the Engine's one set of
    buffers: a new batch, and with a global layer ("G") a new prompt length
    (a new cache capacity)."""
    tcfg = treduce(TD.CONFIG, block_pattern=pattern)
    tm = tbuild(tcfg, TRun(**F32))
    tp = tm.init(torch.Generator().manual_seed(1), device="cpu")
    pol = tft.get_policy("crt3", ber=3e-3, weight_faults=False)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab, shape) for shape in
               ((2, PROMPT), (2, 6), (2, PROMPT), (3, 9))]
    scan = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(max_new_tokens=3),
                          policy=pol, ft_backend="fused")
    kept = []
    for i, toks in enumerate(prompts):
        batch = {"tokens": torch.from_numpy(toks)}
        want = tengine.Engine(
            tm, tp, cfg=tengine.ServeConfig(max_new_tokens=3), policy=pol,
            ft_backend="fused", loop="python").generate(batch, seed=i)
        before = scan._scan_step
        assert torch.equal(scan.generate(batch, seed=i), want), i
        kept.append(scan._scan_step is before)
    assert kept == ([False, True, True, False] if pattern == ("L",)
                    else [False] * 4)


def test_scan_buffers_go_with_their_owner():
    """An Engine's scan buffers and a Scheduler's caches are freed with
    their owner, by reference counting alone (no cycle through the step
    closure), so a dropped server gives back its device memory at once."""
    tm = tbuild(TD.REDUCED, TRun(**F32))
    tp = tm.init(torch.Generator().manual_seed(4), device="cpu")
    eng = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(max_new_tokens=2))
    eng.generate({"tokens": torch.zeros((1, 4), dtype=torch.long)})
    sched = tsched.Scheduler(tm, tp, tsched.SchedulerConfig(
        max_batch=2, buckets=(8,), max_new_tokens=4, decode_chunk=2))
    sched.run([tsched.Request(rid=0, tokens=[1, 2], max_new_tokens=3)])
    step = eng._scan_step
    refs = [weakref.ref(step.caches["l0"]["attn"]["k"]),
            weakref.ref(sched._caches["l0"]["attn"]["k"])]
    del step
    gc.disable()
    try:
        del eng, sched
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


class _NoHostTraffic(TorchDispatchMode):
    """Raises on what a CUDA graph capture cannot hold: a tensor made from
    host data (``lift_fresh``: a Python number or list sent to the
    device), a host read of a device value, ``nonzero`` and a boolean
    index (both sync)."""
    SYNCS = (torch.ops.aten.lift_fresh.default,
             torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default)
    INDEXING = (torch.ops.aten.index.Tensor, torch.ops.aten.index_put_.default,
                torch.ops.aten.index_put.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.SYNCS or (func in self.INDEXING and any(
                i is not None and i.dtype == torch.bool for i in args[1])):
            raise AssertionError(f"{func} in a graphed decode step")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("backend", ("reference", "fused", "pallas"))
def test_scan_step_makes_no_host_traffic(backend):
    """The scan's decode step (at a temperature, under cl with weight
    faults; crt3 on pallas) runs under _NoHostTraffic."""
    tm = tbuild(TD.REDUCED, TRun(**F32))
    tp = tm.init(torch.Generator().manual_seed(2), device="cpu")
    pallas = backend == "pallas"
    eng = tengine.Engine(
        tm, tp, cfg=tengine.ServeConfig(max_new_tokens=1, temperature=0.7),
        policy=tft.get_policy("crt3" if pallas else "cl", ber=3e-3,
                              weight_faults=not pallas),
        ft_backend=backend, ft_t=T_PALLAS if pallas else None)
    eng.generate({"tokens": torch.from_numpy(_prompt())}, seed=0)
    step = eng._scan_step
    with _NoHostTraffic():
        step.graph.step()


def test_scheduler_step_makes_no_host_traffic():
    """The Scheduler's decode step (per-row keys, per-row weight faults, a
    temperature; fused_decode's per-row mode) runs under _NoHostTraffic."""
    tm = tbuild(TD.REDUCED, TRun(**F32))
    tp = tm.init(torch.Generator().manual_seed(3), device="cpu")
    sched = tsched.Scheduler(tm, tp, tsched.SchedulerConfig(
        max_batch=2, buckets=(8,), max_new_tokens=4, decode_chunk=2,
        temperature=0.7), policy=tft.get_policy(
            "crt1", ber=1e-2, weight_faults=True), ft_backend="fused")
    sched.run([tsched.Request(rid=i, tokens=[1, 2, 3 + i], max_new_tokens=3)
               for i in range(3)])
    sched._step.j.zero_()           # the step index within a chunk
    with _NoHostTraffic():
        sched._step.graph.step()


@contextlib.contextmanager
def _no_raise():
    yield


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    outs = [serve.main(["--arch", "h2o-danube-1.8b", "--smoke", "--device",
                        "cpu", "--policy", "cl", "--weight-faults",
                        "--batch", "2", "--prompt-len", "5", "--new", "3",
                        *loop]) for loop in ((), ("--loop", "python"))]
    assert outs[0].shape == (2, 3) and torch.equal(*outs)
    printed = capsys.readouterr().out
    assert "2 host roundtrips (scan loop)" in printed
    assert "4 host roundtrips (python loop)" in printed
    with pytest.raises(RuntimeError, match="no CUDA device") \
            if not torch.cuda.is_available() else _no_raise():
        serve.main(["--arch", "h2o-danube-1.8b", "--smoke", "--new", "1"])


def _pallas_engine(tm, tp, ft_t, loop=None):
    return tengine.Engine(
        tm, tp, cfg=tengine.ServeConfig(max_new_tokens=N_NEW_PALLAS),
        policy=tft.get_policy("crt3", ber=3e-3, weight_faults=False),
        ft_backend="pallas", ft_t=ft_t, loop=loop)


def test_pallas_engine_tokens_match_reference():
    """ft_t as one int, in both loops, and as a {site: int} table over
    every site of the unrolled layout (a site missing from it would
    raise)."""
    _, _, tm, tp = _models()
    toks = _prompt()
    want = np.asarray(_jax_pallas_engine().generate(
        {"tokens": jnp.asarray(toks)}, seed=0))
    table = {name: T_PALLAS for name in _sites(tm.cfg)}
    for ft_t, loop in ((T_PALLAS, "scan"), (T_PALLAS, "python"),
                       (table, "scan")):
        teng = _pallas_engine(tm, tp, ft_t, loop)
        got = teng.generate({"tokens": torch.from_numpy(toks)}, seed=0)
        np.testing.assert_array_equal(got.numpy(), want, f"{ft_t} {loop}")
        assert teng.stats.roundtrips == _roundtrips(loop, N_NEW_PALLAS)


def test_pallas_prefill_logits():
    """At a saturating t the tokens hardly depend on the faults; the logits
    do, so they hold the fault stream (a wrong plane shape or key moves
    them by far more than TOL)."""
    _, _, tm, tp = _models()
    jeng = _jax_pallas_engine()
    toks, key = _prompt(), jax.random.PRNGKey(3)
    _, jl = jeng._prefill(jeng.params, {"tokens": jnp.asarray(toks)},
                          PROMPT + N_NEW_PALLAS, key)
    pol = tft.get_policy("crt3", ber=3e-3, weight_faults=False)
    _, tl = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                       max_len=PROMPT + N_NEW_PALLAS, ftc=TFTCtx(
                           pol, prng.as_key(np.asarray(key)),
                           backend="pallas", t=T_PALLAS))
    assert np.abs(np.asarray(jl) - tl.numpy()).max() <= TOL
    _, clean = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                          max_len=PROMPT + N_NEW_PALLAS, ftc=TFTCtx(
                              pol.with_ber(0.0),
                              prng.as_key(np.asarray(key)),
                              backend="pallas", t=T_PALLAS))
    assert np.abs(clean.numpy() - tl.numpy()).max() > 100 * TOL


def test_linear_reads_the_site_table():
    """Two sites with their own t from one table, through ``linear`` on
    both sides (the reference eagerly, as outside its Engine)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    table = {"l0/attn/wq": 9, "l0/mlp/wi": 12}
    key = jax.random.PRNGKey(6)
    pol = "crt2"
    jftc = jcommon.FTCtx(jft.get_policy(pol, ber=1e-2), key,
                         backend="pallas", t=table)
    tftc = TFTCtx(tft.get_policy(pol, ber=1e-2),
                  prng.as_key(np.asarray(key)), backend="pallas", t=table)
    ys = []
    for name in table:
        want = jcommon.linear(jnp.asarray(x), jnp.asarray(w), ftc=jftc,
                              name=name)
        got = tcommon.linear(torch.from_numpy(x), torch.from_numpy(w),
                             ftc=tftc, name=name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
        ys.append(got)
    assert not torch.equal(*ys)


def test_pallas_engine_refuses_a_site_without_t():
    """The reference Engine compiles its steps, so a pallas site without a
    t fails there; the port's Engine raises the same error, and never
    calibrates per call."""
    tm = tbuild(TD.REDUCED, TRun(**F32))
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="pre-calibrated truncation LSB"):
        _pallas_engine(tm, tp, None).generate(batch)
    table = dict.fromkeys(_sites(tm.cfg), 7)
    del table["l1/mlp/wo"]
    with pytest.raises(ValueError, match="l1/mlp/wo"):
        _pallas_engine(tm, tp, table).generate(batch)
