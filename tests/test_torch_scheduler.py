"""The port's continuous-batching Scheduler against the reference's, on
reduced h2o-danube-1.8b (float32 on both sides, the reference's parameters
carried across by params_from_jax).

The reference side is the jitted ``repro.serve.scheduler.Scheduler``, as its
users run it (under ``jax.disable_jit`` the policy's BER is static, not
traced, and the residual rates, so the faults, differ: ROADMAP.md §C).
Every construction of it compiles anew, so each reference run is made once
per module and its output reused.

  * Port = reference per request, token for token, with equal ``SchedStats``
    (``blocks_in_use_peak`` included), in three runs: clean on a tight block
    pool that makes requests wait for blocks; crt1 at BER 1e-2 without weight
    faults on the port's reference and fused backends (per-row keys, so
    ``fused_decode``'s per-row mode at decode); clean at temperature 0.8
    (per-row sampling keys).
  * The Engine at temperature 0.8 emits the reference Engine's tokens, in
    each loop: the python loop divides by the temperature, the scan, as
    the reference's compiled scan, multiplies by its float32 reciprocal
    after the first token.
  * The Scheduler's default loop="scan" runs its decode step over static
    buffers (a CUDA graph on the card, eager here); loop="python" runs the
    same step eagerly on any device, and is held to the reference too.
    (tests/test_torch_engine.py holds the step free of host traffic.)
  * Port-only invariants: paged = dense; a request alone = in a crowd under
    crt1 with per-row weight faults; fused = reference there; EOS eviction;
    and the guards.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.h2o_danube_1_8b as JD
import repro_torch.configs.h2o_danube_1_8b as TD
from repro import ft as jft
from repro.configs.base import RunConfig as JRun
from repro.configs.base import reduce_config as jreduce
from repro.models import build as jbuild
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch import ft as tft
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import reduce_config as treduce
from repro_torch.convert import params_from_jax
from repro_torch.models import build as tbuild
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
BER = 1e-2

# the three runs held against the reference: (SchedulerConfig fields,
# policy, number of requests)
TIGHT = dict(max_batch=2, buckets=(8,), max_new_tokens=6, decode_chunk=3,
             kv="paged", block_size=4)
RUNS = {
    "tight_pool": (TIGHT, None, 5),
    "crt1": (dict(max_batch=2, buckets=(8,), max_new_tokens=6,
                  decode_chunk=2), "crt1", 3),
    "temperature": (dict(max_batch=2, buckets=(8,), max_new_tokens=6,
                         decode_chunk=3, temperature=0.8), None, 4),
}


@functools.cache
def _models():
    """(jax model, jax params, port model, port params)."""
    jcfg, tcfg = jreduce(JD.CONFIG), treduce(TD.CONFIG)
    jm = jbuild(jcfg, JRun(**F32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg, TRun(**F32))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


def _requests(mod, n, seed=20):
    """Prompts of 3, 5 and 7 tokens (one bucket of 8), 5 or 6 new tokens."""
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, tokens=[int(t) for t in rng.integers(
                0, JD.REDUCED.vocab, 3 + 2 * (i % 3))],
                        max_new_tokens=5 + (i % 2)) for i in range(n)]


@functools.cache
def _tight_n_blocks():
    """The reference test's tight pool: room for one request, plus one."""
    jm, jp, _, _ = _models()
    need1 = jsched.Scheduler(jm, jp, jsched.SchedulerConfig(
        **TIGHT))._blocks_needed(8, 6)
    return 1 + need1 + 1


def _cfg(mod, name, **over):
    kw, _, _ = RUNS[name]
    kw = dict(kw, **over)
    if name == "tight_pool":
        kw["n_blocks"] = _tight_n_blocks()
    return mod.SchedulerConfig(**kw)


@functools.cache
def _jax_run(name):
    """The reference's tokens {rid: (generated, finish_reason)} and stats."""
    jm, jp, _, _ = _models()
    _, policy, n = RUNS[name]
    sched = jsched.Scheduler(jm, jp, _cfg(jsched, name), policy=(
        None if policy is None else jft.get_policy(policy, ber=BER,
                                                   weight_faults=False)))
    out = sched.run(_requests(jsched, n))
    return ({rid: (r.generated, r.finish_reason) for rid, r in out.items()},
            dict(sched.stats.__dict__))


def _port_run(name, backend="reference", weight_faults=False, requests=None,
              loop="scan", **over):
    _, _, tm, tp = _models()
    _, policy, n = RUNS[name]
    sched = tsched.Scheduler(tm, tp, _cfg(tsched, name, **over), policy=(
        None if policy is None else tft.get_policy(
            policy, ber=BER, weight_faults=weight_faults)),
        ft_backend=backend, loop=loop)
    out = sched.run(requests or _requests(tsched, n))
    return ({rid: (r.generated, r.finish_reason) for rid, r in out.items()},
            dict(sched.stats.__dict__))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid] == want[rid], rid


def test_tight_pool_matches_reference():
    """Five requests on two slots and a pool with room for one request plus
    a block: requests wait for blocks; the FIFO block ids, so the peak,
    come out as the reference's."""
    want, wstats = _jax_run("tight_pool")
    got, gstats = _port_run("tight_pool")
    _assert_same(got, want)
    assert gstats == wstats
    assert gstats["blocks_in_use_peak"] <= _tight_n_blocks() - 1
    assert all(len(g) == 5 + rid % 2 and r == "length"
               for rid, (g, r) in got.items())


@pytest.mark.parametrize("backend", ("reference", "fused"))
def test_faulty_run_matches_reference(backend):
    """crt1 at BER 1e-2: the prefill under one key per request, each decode
    step under a (B, 2) key batch (fused: the kernel's per-row mode)."""
    want, wstats = _jax_run("crt1")
    got, gstats = _port_run("crt1", backend)
    _assert_same(got, want)
    assert gstats == wstats


def test_python_loop_matches_reference():
    """loop="python", the same decode step run eagerly on any device, on
    the fused backend under crt1."""
    want, wstats = _jax_run("crt1")
    got, gstats = _port_run("crt1", "fused", loop="python")
    _assert_same(got, want)
    assert gstats == wstats


def test_faults_are_real():
    """The crt1 run's tokens differ from the same workload served clean."""
    want, _ = _jax_run("crt1")
    _, _, tm, tp = _models()
    clean = tsched.Scheduler(tm, tp, _cfg(tsched, "crt1")).run(
        _requests(tsched, RUNS["crt1"][2]))
    assert any(clean[rid].generated != want[rid][0] for rid in want)


def test_temperature_matches_reference():
    """Per-row sampling keys fold_in(fold_in(sbase, rid), tstep + 1), the
    logits scaled by the reciprocal of the temperature."""
    want, wstats = _jax_run("temperature")
    got, gstats = _port_run("temperature")
    _assert_same(got, want)
    assert gstats == wstats
    greedy, _ = _port_run("temperature", temperature=0.0)
    assert greedy != got


@pytest.mark.parametrize("loop", tengine.LOOPS)
def test_engine_temperature_matches_reference(loop):
    """Engine(loop=loop) at temperature 0.8, clean, against the reference
    Engine in the same loop: one sampling key for the whole batch, folded
    by the step index."""
    jm, jp, tm, tp = _models()
    toks = np.random.default_rng(3).integers(0, JD.REDUCED.vocab,
                                             (2, 6)).astype(np.int32)
    want = np.asarray(jengine.Engine(jm, jp, cfg=jengine.ServeConfig(
        max_new_tokens=5, temperature=0.8, loop=loop)).generate(
            {"tokens": jnp.asarray(toks)}, seed=4))
    teng = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(
        max_new_tokens=5, temperature=0.8, loop=loop))
    got = teng.generate({"tokens": torch.from_numpy(toks)}, seed=4)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(
        max_new_tokens=5, loop=loop)).generate(
            {"tokens": torch.from_numpy(toks)}, seed=4)
    assert not torch.equal(got, greedy)


@pytest.mark.parametrize("name", ("tight_pool", "crt1"))
def test_paged_equals_dense(name):
    paged, _ = _port_run(name)
    dense, stats = _port_run(name, kv="dense", n_blocks=None)
    _assert_same(dense, paged)
    assert stats["retire_calls"] == 0 and stats["blocks_in_use_peak"] == 0


def _wf_requests():
    """Request 7, then 8 and 9 beside it."""
    rng = np.random.default_rng(7)
    return [tsched.Request(rid=rid, tokens=[int(t) for t in rng.integers(
                0, JD.REDUCED.vocab, n)], max_new_tokens=6)
            for rid, n in ((7, 5), (8, 3), (9, 7))]


@functools.cache
def _weight_fault_run(backend, crowd):
    """crt1 at BER 1e-2 with per-row weight faults, on three slots: request
    7 alone or in the crowd."""
    reqs = _wf_requests()
    got, _ = _port_run("crt1", backend, weight_faults=True, max_batch=3,
                       requests=reqs if crowd else reqs[:1])
    return got


def test_alone_equals_crowded_with_weight_faults():
    """Per-row keys and scales: a request's tokens do not depend on its
    neighbours, nor on the idle rows that decode into the trash block."""
    assert _weight_fault_run("fused", False)[7] == \
        _weight_fault_run("fused", True)[7]


def test_fused_equals_reference_with_weight_faults():
    crowd = _weight_fault_run("fused", True)
    _assert_same(crowd, _weight_fault_run("reference", True))
    _, _, tm, tp = _models()
    clean = tsched.Scheduler(tm, tp, _cfg(tsched, "crt1", max_batch=3)).run(
        _wf_requests())
    assert any(clean[rid].generated != crowd[rid][0] for rid in crowd)


def test_eos_truncates_and_frees_the_slot():
    probe, _ = _port_run("tight_pool")
    toks = probe[0][0]
    eos = toks[2]
    got, _ = _port_run("tight_pool", eos_id=eos)
    assert got[0] == (toks[:toks.index(eos) + 1], "eos")
    assert sorted(got) == sorted(probe)


def _guard(case):
    _, _, tm, tp = _models()
    pol = tft.get_policy("crt1", ber=1e-3)

    def prompt(n, seed=0):
        return [int(t) for t in np.random.default_rng(seed).integers(
            0, JD.REDUCED.vocab, n)]
    small = tsched.SchedulerConfig(max_batch=2, buckets=(8,),
                                   max_new_tokens=4)
    if case == "window":
        tsched.Scheduler(tm, tp, tsched.SchedulerConfig(buckets=(8, 64)))
    elif case == "max_prompt":
        tsched.Scheduler(tm, tp, tsched.SchedulerConfig(buckets=None))
    elif case == "kv layout":
        tsched.Scheduler(tm, tp, tsched.SchedulerConfig(kv="sparse"))
    elif case == "pallas":
        tsched.Scheduler(tm, tp, policy=pol, ft_backend="pallas")
    elif case == "queue A item 6":
        # the mesh guard: a mesh without a 'model' axis
        from repro_torch.parallel.sharding import AbstractMesh
        tsched.Scheduler(tm, tp, mesh=AbstractMesh((4,), ("data",)))
    elif case == "unknown loop":
        tsched.Scheduler(tm, tp, loop="while")
    elif case == "duplicate":
        tsched.Scheduler(tm, tp, small).run([
            tsched.Request(rid=1, tokens=prompt(4), max_new_tokens=4),
            tsched.Request(rid=1, tokens=prompt(4, 1), max_new_tokens=4)])
    elif case == "capacity":
        tsched.Scheduler(tm, tp, small).run([
            tsched.Request(rid=1, tokens=prompt(4), max_new_tokens=9)])
    elif case == "blocks":
        tsched.Scheduler(tm, tp, tsched.SchedulerConfig(
            max_batch=2, buckets=(8,), max_new_tokens=4, block_size=2,
            n_blocks=3)).run([tsched.Request(rid=1, tokens=prompt(8),
                                             max_new_tokens=4)])
    elif case == "largest bucket":
        tsched.Scheduler(tm, tp, small).run([
            tsched.Request(rid=9, tokens=prompt(20))])


@pytest.mark.parametrize("case", ("window", "max_prompt", "kv layout",
                                  "pallas", "queue A item 6", "unknown loop",
                                  "duplicate",
                                  "capacity", "blocks", "largest bucket"))
def test_scheduler_guards(case):
    match = "needs a 'model' axis" if case == "queue A item 6" else case
    with pytest.raises(ValueError, match=match):
        _guard(case)
