"""The port's MoE, Mamba2-SSD and RG-LRU families against the reference, at
their reduced sizes: qwen3-moe-235b-a22b, mamba2-2.7b and
recurrentgemma-9b (float32 on both sides, the reference's parameters
carried across by params_from_jax), and the dense configs registered with
them (qwen2-7b, glm4-9b, gemma2-27b, dbrx-132b).

Stated tolerances:

  * ``ssd_chunked`` (chunk 8, a 20-step sequence padded with dt = 0 steps
    to 24) and ``_recurrence`` (odd and even lengths): within rtol 1e-5,
    atol 1e-5;
  * ``ssm.apply`` and ``rglru.apply``, a prefill then 3 decode steps:
    outputs and caches within rtol 1e-4, atol 1e-5;
  * each family, clean: prefill logits within 1e-4 (logits are O(3)); the
    temperature-0 tokens of 6 new tokens through the port's
    Engine(loop="scan") and loop="python" equal the reference Engine's;
  * each family under crt2: the port's fused tokens equal its reference
    backend's, and every protected projection of a crt2 prefill, the port's
    fused backend against the reference's ``protect_linear`` on the same
    operands and key, has the same int8 operands and the same output
    words, bit for bit (faulty whole-run tokens across frameworks are not
    held: ROADMAP.md §C);
  * the Scheduler with exact-length prefill: mamba2 alone = in a crowd,
    recurrentgemma paged = dense, and the port's mamba2 tokens = the jitted
    reference Scheduler's; bucketed prefill of R/S models is refused;
  * the dense configs: clean prefill logits within 1e-4.

The prompts are 20 tokens (longer than recurrentgemma's reduced window of
16, so its local layers' caches roll), and the Scheduler's 4-6.  The
reference's prefill pads every cache leaf whose axis 1 happens to equal
the prompt length (``repro/models/model.py``, ``grow``), state rows
included: mamba2's reduced state has 8 heads and its conv history 3 rows,
recurrentgemma's state 64 channels, so prompts of those lengths break the
reference (ROADMAP.md §C); the port grows only attention caches.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import ft as jft
from repro.configs.base import RunConfig as JRun
from repro.core import quantization as JQ
from repro.models import build as jbuild
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch import configs as tconfigs
from repro_torch import ft as tft
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.core import quantization as TQ
from repro_torch.kernels.fused_decode import ops as tops
from repro_torch.models import build as tbuild
from repro_torch.models.common import FTCtx as TFTCtx
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched
from test_torch_engine import _NoHostTraffic

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
FAMILIES = ("qwen3-moe-235b-a22b", "mamba2-2.7b", "recurrentgemma-9b")
DENSE = ("qwen2-7b", "glm4-9b", "gemma2-27b", "dbrx-132b")
ENC_VISION = ("seamless-m4t-medium", "paligemma-3b")
PROMPT, N_NEW = 20, 6
TOL = 1e-4


@functools.cache
def _models(arch, unroll=True):
    """(jax model, jax params, port model, port params) at the reduced size,
    float32."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True),
                               unroll=unroll)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, reduced=True),
                               unroll=unroll)
    jm, tm = jbuild(jcfg, JRun(**F32)), tbuild(tcfg, TRun(**F32))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


def _prompt(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (2, PROMPT)
                                                ).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", FAMILIES + DENSE + ENC_VISION)
def test_config_copies(arch):
    for reduced in (False, True):
        want = jconfigs.get_config(arch, reduced=reduced)
        got = tconfigs.get_config(arch, reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (dataclasses.asdict(tconfigs.get_run_config(arch))
            == dataclasses.asdict(jconfigs.get_run_config(arch)))


def test_unported_archs_say_why():
    """No architecture is left unported: the port registers every one the
    reference does, in its order, full and reduced."""
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for arch in tconfigs.ARCHS:
        for reduced in (False, True):
            assert tconfigs.get_config(arch, reduced).name == \
                jconfigs.get_config(arch, reduced).name


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_scanned(arch):
    """The reference's scanned layout (seg{si}, leaves stacked over a
    segment's blocks, recurrentgemma's tail its own segment; its tree from
    ``Model.param_specs``, filled from a seed): every leaf lands, bit for
    bit and in its dtype, in its layer."""
    cfg = dataclasses.replace(jconfigs.get_config(arch, reduced=True),
                              unroll=False)
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                      jbuild(cfg, JRun()).param_specs())
    tcfg = dataclasses.replace(tconfigs.get_config(arch, reduced=True),
                               unroll=False)
    tp = params_from_jax(jp, tcfg, device="cpu")
    i = 0
    for si, (pattern, n_rep) in enumerate(cfg.segments):
        for r in range(n_rep):
            for j in range(len(pattern)):
                want = jp[f"seg{si}"][f"s{j}"]
                got = tp["layers"][f"l{i}"]
                wl = jax.tree_util.tree_leaves_with_path(want)
                assert len(wl) == len(jax.tree.leaves(got))
                for path, w in wl:
                    g = got
                    for k in path:
                        g = g[k.key]
                    assert g.dtype == (torch.bfloat16
                                       if w.dtype.name == "bfloat16"
                                       else _t(w[r]).dtype)
                    np.testing.assert_array_equal(
                        g.to(torch.float32).numpy(),
                        w[r].astype(np.float32))
                i += 1
    assert i == cfg.n_layers


# ------------------------------------------------------- the SSD and RG-LRU --
def test_ssd_chunked_equals_reference():
    rng = np.random.default_rng(5)
    B, S, H, P, N, chunk = 2, 20, 3, 4, 5, 8
    pad = -S % chunk
    x = rng.standard_normal((B, S + pad, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    dt = np.pad(dt, ((0, 0), (0, pad), (0, 0)))        # dt = 0 padding
    A = (np.abs(rng.standard_normal(H)) + 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S + pad, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S + pad, N)).astype(np.float32)
    want = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                            chunk)
    got = tssm.ssd_chunked(*(_t(a) for a in (x, dt, A, Bm, Cm)), chunk)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S", (12, 13))
def test_recurrence_equals_reference(S):
    rng = np.random.default_rng(S)
    a = (1 / (1 + np.exp(-rng.standard_normal((2, S, 8))))).astype(
        np.float32)
    bx = rng.standard_normal((2, S, 8)).astype(np.float32)
    want = np.asarray(jrglru._recurrence(jnp.asarray(a), jnp.asarray(bx)))
    np.testing.assert_allclose(trglru._recurrence(_t(a), _t(bx)).numpy(),
                               want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mixer", ("ssd", "rglru"))
def test_mixer_prefill_then_decode(mixer):
    """One mixer's prefill (13 tokens, not a chunk multiple), then 3 decode
    steps from its caches: outputs and caches within rtol 1e-4, atol 1e-5
    (the port's decode updates its caches in place)."""
    arch = "mamba2-2.7b" if mixer == "ssd" else "recurrentgemma-9b"
    jm, jp, tm, tp = _models(arch)
    jmod, tmod = (jssm, tssm) if mixer == "ssd" else (jrglru, trglru)
    jpl, tpl = jp["layers"]["l0"][mixer], tp["layers"]["l0"][mixer]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, jm.cfg.d_model)).astype(np.float32)
    kw = dict(run=None, name=mixer)
    jprefill, jdecode = (jax.jit(functools.partial(
        jmod.apply, cfg=jm.cfg, mode=mode, **kw)) for mode in ("prefill",
                                                               "decode"))
    jy, jc = jprefill(jpl, jnp.asarray(x[:, :13]))
    ty, tc = tmod.apply(tpl, _t(x[:, :13]), cfg=tm.cfg, mode="prefill", **kw)
    outs = [(jy, ty, jc, {k: v.clone() for k, v in tc.items()})]
    for s in range(13, 16):
        jy, jc = jdecode(jpl, jnp.asarray(x[:, s:s + 1]), cache=jc)
        ty, tc = tmod.apply(tpl, _t(x[:, s:s + 1]), cfg=tm.cfg,
                            mode="decode", cache=tc, **kw)
        outs.append((jy, ty, {k: np.asarray(v) for k, v in jc.items()},
                     {k: v.clone() for k, v in tc.items()}))
    for jy, ty, jc, tc in outs:
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-5)
        assert sorted(tc) == sorted(jc)
        for k in jc:
            assert tc[k].dtype == _t(np.asarray(jc[k])).dtype, k
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


# ------------------------------------------------------- families, clean --
@functools.cache
def _jax_tokens(arch):
    jm, jp, _, _ = _models(arch)
    eng = jengine.Engine(jm, jp, cfg=jengine.ServeConfig(
        max_new_tokens=N_NEW, loop="python"))
    return np.asarray(eng.generate({"tokens": jnp.asarray(
        _prompt(jm.cfg.vocab))}))


def _prefill_logits(arch):
    jm, jp, tm, tp = _models(arch)
    toks = _prompt(jm.cfg.vocab)
    _, jl = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                            max_len=PROMPT + N_NEW))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        _, tl = tm.prefill(tp, {"tokens": _t(toks).long()},
                           max_len=PROMPT + N_NEW)
    return np.asarray(jl), tl.numpy()


@pytest.mark.parametrize("arch", FAMILIES + DENSE)
def test_clean_prefill_logits(arch):
    want, got = _prefill_logits(arch)
    assert np.abs(want - got).max() <= TOL


@pytest.mark.parametrize("loop", tengine.LOOPS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_clean_tokens_equal_reference(arch, loop):
    _, _, tm, tp = _models(arch)
    eng = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(
        max_new_tokens=N_NEW), loop=loop)
    got = eng.generate({"tokens": _t(_prompt(tm.cfg.vocab)).long()})
    np.testing.assert_array_equal(got.numpy(), _jax_tokens(arch))
    assert eng.stats.roundtrips == (2 if loop == "scan" else 1 + N_NEW)


# ------------------------------------------------------- families, crt2 --
def _crt2(mod):
    return mod.get_policy("crt2", ber=1e-2)


@functools.cache
def _port_crt2_sites(arch):
    """Every protected projection of the port's crt2 prefill on the fused
    backend: (key, x, w, layer_protected, y, yq, t) in call order, yq and
    t the int8 words and truncation LSBs ``fused_decode`` gave."""
    _, _, tm, tp = _models(arch)
    real_pl, real_rescale = tft.protect_linear, tops.rescale
    calls, words = [], []

    def rescale(yq, sx, sw, t):
        words.append((yq.numpy().copy(), t.numpy().copy()))
        return real_rescale(yq, sx, sw, t)

    def recorded(key, x, w, policy, important=None, **kw):
        y = real_pl(key, x, w, policy, important, **kw)
        calls.append((key.numpy().copy(), x.numpy().copy(), w.numpy().copy(),
                      kw.get("layer_protected", True), y.numpy().copy(),
                      *words.pop()))
        return y
    ftc = TFTCtx(_crt2(tft), prng.as_key(np.asarray(jax.random.PRNGKey(3))),
                 backend="fused")
    toks = _t(_prompt(tm.cfg.vocab, seed=2)).long()
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(tft, "protect_linear", recorded)
        mp.setattr(tops, "rescale", rescale)
        tm.prefill(tp, {"tokens": toks}, max_len=PROMPT + 1, ftc=ftc)
    return calls


@pytest.mark.parametrize("arch", FAMILIES)
def test_crt2_projections_bitwise(arch):
    """Each protected projection of a crt2 prefill, the port's fused
    backend against the reference's ``protect_linear`` on the same
    operands and key: the int8 operands and scales equal, and the
    reference's float output is the port's int8 words at its t, exactly
    (|yq| <= 128; the reference's compiled rescale may move y by an ulp,
    ROADMAP.md §C)."""
    calls = _port_crt2_sites(arch)
    jm = _models(arch)[0]
    per_kind = {"G": 4, "L": 4, "R": 3, "S": 2}
    ffn = 1 if jm.cfg.moe else (3 if jm.cfg.d_ff else 0)
    kinds = list(jm.cfg.block_pattern) * jm.cfg.n_blocks + list(jm.cfg.tail)
    assert len(calls) == sum(per_kind[k] + ffn for k in kinds)
    policy = _crt2(jft)
    for call in calls:
        hold_site(call, policy)


def hold_site(call, policy):
    """One recorded projection (key, x, w, layer_protected, y, yq, t)
    against the reference's ``protect_linear`` under ``policy``: the int8
    operands and scales equal, the reference's output the port's words."""
    key, x, w, prot, got, yq, tt = call
    jxq, jsx = JQ.quantize(jnp.asarray(x))
    jwq, jsw = JQ.quantize(jnp.asarray(w))
    txq, tsx = TQ.quantize(_t(x))
    twq, tsw = TQ.quantize(_t(w))
    for j, t in ((jxq, txq), (jsx, tsx), (jwq, twq), (jsw, tsw)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jkey = jnp.asarray((key.astype(np.int64) & 0xFFFFFFFF)
                       .astype(np.uint32))
    y = np.asarray(jft.protect_linear(jkey, jnp.asarray(x),
                                      jnp.asarray(w), policy,
                                      layer_protected=prot))
    assert np.abs(yq).max() <= 128
    scale = (tsx * tsw * torch.exp2(_t(tt).to(torch.float32))).numpy()
    ratio = y.astype(np.float64) / scale.astype(np.float64)
    assert np.abs(ratio - np.rint(ratio)).max() < 1e-3
    np.testing.assert_array_equal(np.rint(ratio), yq)
    np.testing.assert_array_equal(got == 0, y == 0)
    assert np.abs(got - y).max() <= 4e-7 * np.abs(y).max()


@pytest.mark.parametrize("arch", FAMILIES)
def test_crt2_fused_tokens_equal_reference_backend(arch):
    """3 new tokens: the prefill and two graphed decode steps."""
    _, _, tm, tp = _models(arch)
    toks = {"tokens": _t(_prompt(tm.cfg.vocab, seed=2)).long()}
    out = [tengine.Engine(tm, tp, cfg=tengine.ServeConfig(
        max_new_tokens=3), policy=_crt2(tft), ft_backend=b).generate(
            toks).numpy() for b in ("reference", "fused")]
    np.testing.assert_array_equal(out[1], out[0])


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_makes_no_host_traffic(arch):
    """The scan's decode step of each family (crt3, fused) holds nothing a
    CUDA graph capture cannot: MoE dispatch, SSD and RG-LRU updates."""
    _, _, tm, tp = _models(arch)
    eng = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(
        max_new_tokens=1, temperature=0.7), policy="crt3",
        ft_backend="fused")
    eng.generate({"tokens": _t(_prompt(tm.cfg.vocab)).long()})
    with _NoHostTraffic():
        eng._scan_step.graph.step()


# ---------------------------------------------------------- the Scheduler --
def _requests(mod, vocab, n, lens, max_new, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, tokens=[int(t) for t in rng.integers(
        0, vocab, lens[i % len(lens)])], max_new_tokens=max_new)
        for i in range(n)]


MAMBA_SCHED = dict(max_batch=2, buckets=None, max_prompt=8,
                   max_new_tokens=5, decode_chunk=2)


def _tokens(out):
    return {rid: r.generated for rid, r in out.items()}


def test_scheduler_mamba2_equals_reference_and_alone():
    jm, jp, tm, tp = _models("mamba2-2.7b")
    mk = functools.partial(_requests, vocab=tm.cfg.vocab, n=3, lens=(4, 6),
                           max_new=5, seed=30)
    want = _tokens(jsched.Scheduler(jm, jp, jsched.SchedulerConfig(
        **MAMBA_SCHED)).run(mk(jsched)))
    sched = tsched.Scheduler(tm, tp, tsched.SchedulerConfig(**MAMBA_SCHED))
    crowd = _tokens(sched.run(mk(tsched)))
    assert crowd == want
    assert all(len(g) == 5 for g in crowd.values())
    alone = _tokens(sched.run(mk(tsched)[:1]))
    assert alone[0] == crowd[0]


def test_scheduler_recurrentgemma_paged_equals_dense():
    _, _, tm, tp = _models("recurrentgemma-9b")
    outs = {kv: _tokens(tsched.Scheduler(tm, tp, tsched.SchedulerConfig(
        max_batch=2, buckets=None, max_prompt=6, max_new_tokens=4,
        decode_chunk=2, kv=kv)).run(_requests(
            tsched, tm.cfg.vocab, 3, (4, 5), 4, seed=60)))
        for kv in ("dense", "paged")}
    assert outs["paged"] == outs["dense"]
    assert all(len(g) == 4 for g in outs["paged"].values())


@pytest.mark.parametrize("arch", ("mamba2-2.7b", "recurrentgemma-9b"))
def test_scheduler_refuses_bucketed_recurrent_prefill(arch):
    _, _, tm, tp = _models(arch)
    with pytest.raises(ValueError, match="buckets=None"):
        tsched.Scheduler(tm, tp, tsched.SchedulerConfig(buckets=(8,)))


def test_init_cache_state_rows():
    """R and S layers keep dense per-slot state rows under both layouts:
    float32 recurrent state, the conv history in the compute dtype."""
    for arch in ("mamba2-2.7b", "recurrentgemma-9b"):
        jm = jbuild(jconfigs.get_config(arch, reduced=True), JRun())
        tm = tbuild(tconfigs.get_config(arch, reduced=True), TRun())
        want = jax.tree.map(np.asarray, jm.init_cache(3, 12))
        for paged in (None, (4, 9)):
            got = tm.init_cache(3, 12, device="cpu", paged=paged)
            for lid, layer in want.items():
                for key in ("rglru", "ssd"):
                    if key in layer:
                        for name, w in layer[key].items():
                            g = got[lid][key][name]
                            assert tuple(g.shape) == w.shape
                            assert (g.dtype == torch.float32) == (
                                w.dtype == np.float32)
