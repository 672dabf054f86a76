"""The port's encoder-decoder and vision-frontend families against the
reference, at their reduced sizes: seamless-m4t-medium (a 2-layer encoder,
2 decoder layers with cross-attention) and paligemma-3b (8 patch
embeddings in front of the tokens), float32 on both sides, the
reference's parameters carried across by params_from_jax.

Stated tolerances:

  * ``chunked_attention``, causal and not, S = 16 queries against T = 24
    keys in blocks of 8 (and in one block): within rtol 1e-5, atol 1e-5;
  * ``encode`` (unrolled, and scanned with ``unroll=False``): within 1e-5;
    the scanned encoder makes no ``protect_linear`` call under a policy,
    as the reference's scan body passes no fault context;
  * clean prefill logits within 1e-4 (logits are O(3)); the temperature-0
    tokens of 6 new tokens through the port's Engine(loop="scan") and
    loop="python" equal the reference Engine's; seamless's frames are 13
    rows against a 9-token prompt, so a swap of the two lengths shows;
  * under crt2: every protected projection of a prefill (the encoder's
    ``enc{i}`` sites and the cross-attention's ``xk``/``xv`` included, in
    the reference's order and with its site names) has the reference
    ``protect_linear``'s int8 operands and output words, bit for bit; the
    fused tokens equal the reference backend's;
  * the decode step over cross caches, with and without a per-row ``cn``,
    makes no host traffic;
  * the seamless Scheduler (exact-length, paged, frames of 5-7 rows, so
    ``cn`` differs per slot) and the paligemma Scheduler (bucketed, 8
    patch rows per request) emit the jitted reference Scheduler's tokens;
    a seamless request alone emits what it emits in a crowd; the dense
    layout is refused for an encoder-decoder;
  * ``Model.loss`` within 1e-5, the vision loss over its -1 labels.

Each reference jit is compiled once per module (``functools.cache``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ft as jft
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jT
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch import ft as tft
from repro_torch.core import prng
from repro_torch.kernels.fused_decode import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tT
from repro_torch.models.common import FTCtx as TFTCtx
from repro_torch.serve import engine as tengine
from repro_torch.serve import scheduler as tsched
from test_torch_engine import _NoHostTraffic
from test_torch_families import _crt2, _models, _t, _tokens, hold_site

torch.set_num_threads(1)

ARCHS = ("seamless-m4t-medium", "paligemma-3b")
PROMPT, FRAMES, N_NEW = 9, 13, 6
TOL = 1e-4


def _batch(cfg, seed=1, B=2):
    """Numpy inputs: tokens, and the family's frames or patch embeddings."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)}
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: _t(v).long() if k == "tokens" else _t(v)
            for k, v in b.items()}


# --------------------------------------------------------------- attention --
@pytest.mark.parametrize("block", (8, 64))
@pytest.mark.parametrize("causal", (False, True))
def test_chunked_attention_equals_reference(causal, block):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, block=block)
    got = tattn.chunked_attention(*map(_t, (q, k, v)), causal=causal,
                                  block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------- encoder --
@pytest.mark.parametrize("unroll", (True, False))
def test_encode_equals_reference(unroll, monkeypatch):
    jm, jp, tm, tp = _models("seamless-m4t-medium", unroll)
    frames = _batch(jm.cfg)["frames"]
    want = jax.jit(lambda p, f: jT.encode(p, f, cfg=jm.cfg, run=jm.run))(
        jp, jnp.asarray(frames))
    calls = []
    real = tft.protect_linear
    monkeypatch.setattr(tft, "protect_linear",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ftc = TFTCtx(_crt2(tft), prng.PRNGKey(0), backend="fused")
    with torch.no_grad():
        got = tT.encode(tp, _t(frames), cfg=tm.cfg, run=tm.run)
        faulty = tT.encode(tp, _t(frames), cfg=tm.cfg, run=tm.run, ftc=ftc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if unroll:
        assert len(calls) == 6 * tm.cfg.n_enc_layers
    else:                       # the scanned encoder runs clean
        assert not calls
        assert torch.equal(faulty, got)


# ------------------------------------------------------------------- clean --
@functools.cache
def _jax_tokens(arch):
    jm, jp, _, _ = _models(arch)
    eng = jengine.Engine(jm, jp, cfg=jengine.ServeConfig(
        max_new_tokens=N_NEW, loop="python"))
    return np.asarray(eng.generate(_jb(_batch(jm.cfg))))


@pytest.mark.parametrize("arch", ARCHS)
def test_clean_prefill_logits(arch):
    jm, jp, tm, tp = _models(arch)
    b = _batch(jm.cfg)
    max_len = PROMPT + tm.cfg.n_frontend_tokens + N_NEW
    jc, jl = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))(
        jp, _jb(b))
    with torch.no_grad():
        tc, tl = tm.prefill(tp, _tb(b), max_len=max_len)
    assert np.abs(np.asarray(jl) - tl.numpy()).max() <= TOL
    for lid, layer in jc.items():       # the caches' layout and lengths
        assert sorted(tc[lid]) == sorted(layer)
        for key, c in layer.items():
            for name, leaf in c.items():
                assert tuple(tc[lid][key][name].shape) == leaf.shape


@pytest.mark.parametrize("loop", tengine.LOOPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_clean_tokens_equal_reference(arch, loop):
    _, _, tm, tp = _models(arch)
    eng = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(
        max_new_tokens=N_NEW), loop=loop)
    got = eng.generate(_tb(_batch(tm.cfg)))
    np.testing.assert_array_equal(got.numpy(), _jax_tokens(arch))
    assert eng.stats.roundtrips == (2 if loop == "scan" else 1 + N_NEW)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_equals_reference(arch):
    jm, jp, tm, tp = _models(arch)
    b = _batch(jm.cfg, seed=5)
    want, _ = jax.jit(lambda p, b: jm.loss(p, b))(jp, _jb(b))
    with torch.no_grad():
        got, _ = tm.loss(tp, _tb(b))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------------- crt2 --
class _Sites(jcommon.FTCtx):
    """The reference's context, recording each site name it keys."""
    names: list

    def site_key(self, name):
        self.names.append(name)
        return super().site_key(name)


def _reference_site_names(arch):
    """The reference prefill's protected sites in call order, traced
    abstractly (``jax.eval_shape``): nothing compiles or runs."""
    jm, jp, _, _ = _models(arch)
    ftc = _Sites(_crt2(jft), jax.random.PRNGKey(3))
    ftc.names = []
    jax.eval_shape(lambda p, b: jm.prefill(p, b, max_len=PROMPT + 1 +
                                           jm.cfg.n_frontend_tokens,
                                           ftc=ftc), jp, _jb(_batch(jm.cfg, 2)))
    return ftc.names


@pytest.mark.parametrize("arch", ARCHS)
def test_crt2_projections_bitwise(arch):
    """Each protected projection of a crt2 prefill, the port's fused
    backend against the reference's ``protect_linear`` on the same
    operands and key (``test_torch_families.hold_site``), the sites those
    of the reference's prefill, in its order."""
    _, _, tm, tp = _models(arch)
    real_pl, real_rescale = tft.protect_linear, tops.rescale
    calls, words, names = [], [], []

    class Sites(TFTCtx):
        def site_key(self, name):
            names.append(name)
            return super().site_key(name)

    def rescale(yq, sx, sw, t):
        words.append((yq.numpy().copy(), t.numpy().copy()))
        return real_rescale(yq, sx, sw, t)

    def recorded(key, x, w, policy, important=None, **kw):
        y = real_pl(key, x, w, policy, important, **kw)
        calls.append((key.numpy().copy(), x.numpy().copy(), w.numpy().copy(),
                      kw.get("layer_protected", True), y.numpy().copy(),
                      *words.pop()))
        return y
    ftc = Sites(_crt2(tft), prng.as_key(np.asarray(jax.random.PRNGKey(3))),
                backend="fused")
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(tft, "protect_linear", recorded)
        mp.setattr(tops, "rescale", rescale)
        tm.prefill(tp, _tb(_batch(tm.cfg, 2)),
                   max_len=PROMPT + 1 + tm.cfg.n_frontend_tokens, ftc=ftc)
    assert names == _reference_site_names(arch)
    if tm.cfg.enc_dec:
        assert "enc1/mlp/wo" in names and "l1/xv" in names
    per_layer = 4 + (2 if not tm.cfg.glu else 3) + 4 * tm.cfg.enc_dec
    enc = tm.cfg.n_enc_layers * (4 + (2 if not tm.cfg.glu else 3))
    assert len(calls) == tm.cfg.n_layers * per_layer + enc
    for call in calls:
        hold_site(call, _crt2(jft))


@pytest.mark.parametrize("arch", ARCHS)
def test_crt2_fused_tokens_equal_reference_backend(arch):
    """3 new tokens: the prefill and two graphed decode steps."""
    _, _, tm, tp = _models(arch)
    b = _tb(_batch(tm.cfg, 2))
    out = [tengine.Engine(tm, tp, cfg=tengine.ServeConfig(
        max_new_tokens=3), policy=_crt2(tft), ft_backend=be).generate(
            b).numpy() for be in ("reference", "fused")]
    np.testing.assert_array_equal(out[1], out[0])


# ---------------------------------------------------------- the Scheduler --
SEAMLESS_SCHED = dict(max_batch=2, buckets=None, max_prompt=8,
                      max_new_tokens=5, decode_chunk=2)
PALIGEMMA_SCHED = dict(max_batch=2, buckets=(8,), max_new_tokens=5,
                       decode_chunk=2)


def _requests(mod, cfg, n=3):
    """Prompts of 4-6 tokens; seamless's frames of 7, 5 and 6 rows (never
    its prompt's length), paligemma's 8 patch rows."""
    rng = np.random.default_rng(40)
    out = []
    for i in range(n):
        toks = [int(t) for t in rng.integers(0, cfg.vocab, (4, 6, 5)[i % 3])]
        rows = (7, 5, 6)[i % 3] if cfg.enc_dec else cfg.n_frontend_tokens
        emb = rng.standard_normal((rows, cfg.d_model)).astype(np.float32)
        out.append(mod.Request(rid=i, tokens=toks, max_new_tokens=5,
                               extras={"frames" if cfg.enc_dec
                                       else "patch_embeds": emb}))
    return out


@functools.cache
def _jax_scheduler_tokens(arch):
    jm, jp, _, _ = _models(arch)
    sc = SEAMLESS_SCHED if jm.cfg.enc_dec else PALIGEMMA_SCHED
    return _tokens(jsched.Scheduler(jm, jp, jsched.SchedulerConfig(**sc))
                   .run(_requests(jsched, jm.cfg)))


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_equals_reference(arch):
    _, _, tm, tp = _models(arch)
    sc = SEAMLESS_SCHED if tm.cfg.enc_dec else PALIGEMMA_SCHED
    sched = tsched.Scheduler(tm, tp, tsched.SchedulerConfig(**sc))
    crowd = _tokens(sched.run(_requests(tsched, tm.cfg)))
    assert crowd == _jax_scheduler_tokens(arch)
    assert all(len(g) == 5 for g in crowd.values())
    if tm.cfg.enc_dec:
        cn = sched._caches["l0"]["cross"]["cn"]
        assert sorted(cn.tolist()) == [5, 6]     # the last two requests'
        alone = _tokens(sched.run(_requests(tsched, tm.cfg)[2:]))
        assert alone[2] == crowd[2]


def test_scheduler_refuses_dense_encdec():
    _, _, tm, tp = _models("seamless-m4t-medium")
    with pytest.raises(ValueError, match="cn"):
        tsched.Scheduler(tm, tp, tsched.SchedulerConfig(**SEAMLESS_SCHED,
                                                        kv="dense"))


@pytest.mark.parametrize("where", ("engine", "scheduler"))
def test_cross_decode_step_makes_no_host_traffic(where):
    """The graphed decode step over cross caches: the Engine's (the whole
    buffer valid) and the Scheduler's (a per-row ``cn``), crt3, fused."""
    _, _, tm, tp = _models("seamless-m4t-medium")
    if where == "engine":
        eng = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(
            max_new_tokens=1), policy="crt3", ft_backend="fused")
        eng.generate(_tb(_batch(tm.cfg)))
        step = eng._scan_step.graph
    else:
        sched = tsched.Scheduler(tm, tp, tsched.SchedulerConfig(
            **SEAMLESS_SCHED), policy="crt3", ft_backend="fused")
        sched.run(_requests(tsched, tm.cfg, n=2))
        sched._step.j.zero_()           # the step index within a chunk
        step = sched._step.graph
    with _NoHostTraffic():
        step.step()


def test_scanned_params_from_jax_carry_the_encoder():
    """``enc_blocks/s0`` (stacked on axis 0) lands in one dict per encoder
    layer; each decoder layer carries its ``lnx`` and ``xattn``."""
    jm, jp, _, tp = _models("seamless-m4t-medium", False)
    for i in range(jm.cfg.n_enc_layers):
        for path, w in jax.tree_util.tree_leaves_with_path(
                jp["enc_blocks"]["s0"]):
            g = tp["enc_layers"][f"l{i}"]
            for k in path:
                g = g[k.key]
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[i])
    assert {"lnx", "xattn"} <= set(tp["layers"]["l1"])
    np.testing.assert_array_equal(tp["enc_norm"].numpy(),
                                  np.asarray(jp["enc_norm"]))


def test_init_cache_cross_rows():
    """``init_cache(enc_len=)``: cross rows of the encoder's length and a
    per-row int32 ``cn``; without it, rows of ``seq_len`` and no ``cn``."""
    jm, _, tm, _ = _models("seamless-m4t-medium")
    for enc_len in (None, 7):
        want = jm.init_cache(3, 12, paged=(4, 9), enc_len=enc_len)
        got = tm.init_cache(3, 12, device="cpu", paged=(4, 9),
                            enc_len=enc_len)
        for lid, layer in want.items():
            assert sorted(got[lid]["cross"]) == sorted(layer["cross"])
            for name, w in layer["cross"].items():
                g = got[lid]["cross"][name]
                assert tuple(g.shape) == w.shape
                assert str(g.dtype).split(".")[1] == str(w.dtype)

