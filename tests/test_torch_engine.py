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
    of the reference's own fused-vs-reference engine test).  crt3 runs the
    scanned layout (unroll=False, one set of site names for every layer),
    as full-width configs do, and its prefill logits are held to TOL too.
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
import types

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

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
N_NEW = 5
PROMPT = 20            # longer than the reduced window (16): the cache rolls
TOL = 1e-4
N_NEW_PALLAS = 2       # its planes cover 128 padded rows: slow on the CPU
T_PALLAS = 6


# the policy's layout: crt3 on the scanned one, the others unrolled
UNROLL = {None: True, "cl": True, "crt3": False}


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
    _, _, tm, tp = _models()
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


@pytest.mark.parametrize("policy,weight_faults", (("crt3", False),
                                                  ("cl", True)))
def test_engine_tokens_match_reference(policy, weight_faults):
    _, _, tm, tp = _models(UNROLL[policy])
    toks = _prompt()
    want = np.asarray(_jax_engine(policy, weight_faults).generate(
        {"tokens": jnp.asarray(toks)}, seed=0))
    for backend in ("reference", "fused"):
        teng = tengine.Engine(
            tm, tp, cfg=tengine.ServeConfig(max_new_tokens=N_NEW),
            policy=tft.get_policy(policy, ber=3e-3,
                                  weight_faults=weight_faults),
            ft_backend=backend)
        got = teng.generate({"tokens": torch.from_numpy(toks)}, seed=0)
        np.testing.assert_array_equal(got.numpy(), want, backend)
        assert teng.stats.roundtrips == 1 + N_NEW
        assert teng.stats.tokens == want.size


def test_engine_refuses_what_is_not_ported():
    tm = tbuild(TD.REDUCED, TRun(**F32))
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="CUDA graph"):
        tengine.Engine(tm, tp, loop="scan")
    out = tengine.Engine(tm, tp, cfg=tengine.ServeConfig(
        max_new_tokens=0)).generate({"tokens": torch.zeros(
            (1, 4), dtype=torch.long)})
    assert out.shape == (1, 0)


@contextlib.contextmanager
def _no_raise():
    yield


def test_serve_launcher_on_cpu():
    from repro_torch.launch import serve
    out = serve.main(["--arch", "h2o-danube-1.8b", "--smoke", "--device",
                      "cpu", "--policy", "cl", "--weight-faults", "--batch",
                      "2", "--prompt-len", "5", "--new", "3"])
    assert out.shape == (2, 3)
    with pytest.raises(RuntimeError, match="no CUDA device") \
            if not torch.cuda.is_available() else _no_raise():
        serve.main(["--arch", "h2o-danube-1.8b", "--smoke", "--new", "1"])


def _pallas_engine(tm, tp, ft_t):
    return tengine.Engine(
        tm, tp, cfg=tengine.ServeConfig(max_new_tokens=N_NEW_PALLAS),
        policy=tft.get_policy("crt3", ber=3e-3, weight_faults=False),
        ft_backend="pallas", ft_t=ft_t)


def test_pallas_engine_tokens_match_reference():
    """ft_t as one int, and as a {site: int} table over every site of the
    unrolled layout (a site missing from it would raise)."""
    _, _, tm, tp = _models()
    toks = _prompt()
    want = np.asarray(_jax_pallas_engine().generate(
        {"tokens": jnp.asarray(toks)}, seed=0))
    table = {name: T_PALLAS for name in _sites(tm.cfg)}
    for ft_t in (T_PALLAS, table):
        teng = _pallas_engine(tm, tp, ft_t)
        got = teng.generate({"tokens": torch.from_numpy(toks)}, seed=0)
        np.testing.assert_array_equal(got.numpy(), want, str(ft_t))
        assert teng.stats.roundtrips == 1 + N_NEW_PALLAS


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
