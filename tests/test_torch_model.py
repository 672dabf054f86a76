"""The port's dense decoder against the reference on reduced h2o-danube-1.8b
(the logits of prefill and decode are held in tests/test_torch_engine.py,
on the reference Engine's executables).

Both sides run in float32 (RunConfig(param_dtype="float32",
compute_dtype="float32")) with the reference's parameters carried across by
repro_torch.convert.params_from_jax, so the tolerance speaks of the
algorithm.  Stated tolerance: |logit difference| <= 1e-4 (logits are O(3)).
The two frameworks round float32 ops differently (rsqrt, pow, exp and the
order of matmul sums), which moves logits by about 1e-6; a wrong site key,
cache slot or mask moves them by 1e-2 and more.
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
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models.common import FTCtx as JFTCtx
from repro.models.common import linear as jlinear
from repro_torch import ft as tft
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import reduce_config as treduce
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import transformer as T
from repro_torch.models.common import FTCtx as TFTCtx
from repro_torch.models.common import linear as tlinear

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

TOL = 1e-4
PROMPT = 20            # longer than the reduced window (16): the cache rolls
F32 = dict(param_dtype="float32", compute_dtype="float32")


@functools.cache
def _pair(unroll):
    """(jax model, jax params, port model, port params) for one layout."""
    jcfg = jreduce(JD.CONFIG, unroll=unroll)
    tcfg = treduce(TD.CONFIG, unroll=unroll)
    jm, tm = jbuild(jcfg, JRun(**F32)), tbuild(tcfg, TRun(**F32))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, jp, tm, params_from_jax(jp, tcfg, device="cpu")


def _ftcs(policy, key, masks=None):
    if policy is None:
        return None, None
    return (JFTCtx(jft.get_policy(policy, ber=3e-3), key, masks=masks),
            TFTCtx(tft.get_policy(policy, ber=3e-3),
                   prng.as_key(np.asarray(key)), masks=masks))


def _prompt(vocab):
    return np.random.default_rng(1).integers(0, vocab, (2, PROMPT)
                                             ).astype(np.int32)


def test_config_copy():
    assert get_config("h2o-danube-1.8b") == TD.CONFIG
    assert get_config("h2o-danube-1.8b", reduced=True).unroll
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "vocab", "window", "block_pattern"):
        assert getattr(TD.CONFIG, f) == getattr(JD.CONFIG, f), f
        assert getattr(TD.REDUCED, f) == getattr(JD.REDUCED, f), f


@pytest.mark.parametrize("unroll", (True, False), ids=("unrolled", "scanned"))
def test_params_from_jax_round_trip(unroll):
    """Every leaf of both layouts lands, bit for bit, in its layer."""
    jm, jp, tm, tp = _pair(unroll)
    assert set(tp["layers"]) == {f"l{i}" for i in range(jm.cfg.n_layers)}

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    np.testing.assert_array_equal(tp["embed"].numpy(), jp["embed"])
    for i in range(jm.cfg.n_layers):
        src = (jp["layers"][f"l{i}"] if "layers" in jp else
               jax.tree.map(lambda a: a[i], jp["seg0"]["s0"]))
        got = dict(leaves(tp["layers"][f"l{i}"]))
        for path, want in leaves(src):
            np.testing.assert_array_equal(got[path].numpy(), want, path)


def _prefill(pair, policy, key, masks=None):
    jm, jp, tm, tp = pair
    toks = _prompt(jm.cfg.vocab)
    jftc, tftc = _ftcs(policy, key, masks)
    jc, jl = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=PROMPT + 2,
                        ftc=jftc)
    tc, tl = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        max_len=PROMPT + 2, ftc=tftc)
    assert np.abs(np.asarray(jl) - tl.numpy()).max() <= TOL
    return jc, jl, tc, toks


def test_scanned_site_names(monkeypatch):
    """With ``unroll=False`` the reference traces its scan body once, so
    every layer draws from the same site names (``sb0/s0/...``) and keys;
    the port calls the same names in the same order for each layer, and
    per-layer names would draw other faults.  (The numbers on this layout
    are held in tests/test_torch_engine.py: crt3 runs the scanned model.)"""
    jm, jp, tm, tp = _pair(False)
    assert set(T.layer_names(tm.cfg)) == {"sb0/s0"}
    toks = _prompt(jm.cfg.vocab)
    names = {"jax": [], "port": []}
    for side, cls in (("jax", JFTCtx), ("port", TFTCtx)):
        real = cls.site_key

        def record(self, name, real=real, seen=names[side]):
            seen.append(name)
            return real(self, name)
        monkeypatch.setattr(cls, "site_key", record)
    jftc, tftc = _ftcs("cl", jax.random.PRNGKey(3))
    jax.eval_shape(lambda p, t: jm.prefill(p, {"tokens": t}, ftc=jftc)[1],
                   jp, jnp.asarray(toks))
    batch = {"tokens": torch.from_numpy(toks).long()}
    _, right = tm.prefill(tp, batch, ftc=tftc)
    per_layer = list(dict.fromkeys(names["jax"]))
    assert len(per_layer) == 7 and all(n.startswith("sb0/s0/")
                                       for n in per_layer)
    assert names["port"] == per_layer * jm.cfg.n_layers

    monkeypatch.setattr(T, "layer_names", lambda cfg: [
        f"l{i}" for i in range(cfg.n_layers)])
    _, wrong = tm.prefill(tp, batch, ftc=tftc)
    assert (right - wrong).abs().max() > 100 * TOL


def test_linear_per_row_keys():
    """``linear`` with a (B, 2) key batch: each row's site key is folded per
    row and repeats over that row's S positions; masks pick the DPPU's
    important channels by site name."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 0.2).astype(np.float32)
    masks = {"l0/mlp/wi": rng.random(40) < 0.3}
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3))
    jftc, tftc = _ftcs("cl", keys, masks)
    want = jlinear(jnp.asarray(x), jnp.asarray(w), ftc=jftc, name="l0/mlp/wi")
    got = tlinear(torch.from_numpy(x), torch.from_numpy(w), ftc=tftc,
                  name="l0/mlp/wi")
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)
    assert np.abs(np.asarray(want) - got.numpy()).max() <= TOL


@pytest.mark.parametrize("window", (0, 16))
def test_chunked_attention(window):
    """The blocked online softmax (prompts longer than the attention
    block), with and without a sliding window that skips kv blocks."""
    rng = np.random.default_rng(4)
    q = (rng.standard_normal((2, 32, 4, 8)) * 0.5).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=window, block=8)
    got = tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window,
                                  block=8)
    assert np.abs(np.asarray(want) - got.numpy()).max() <= TOL


def test_build_cache_rolls_like_reference():
    rng = np.random.default_rng(5)
    for S in (5, 16, 21, 35):
        k = rng.standard_normal((1, S, 2, 4)).astype(np.float32)
        want = jattn._build_cache(jnp.asarray(k), jnp.asarray(k), 16)
        got = tattn._build_cache(torch.from_numpy(k), torch.from_numpy(k), 16)
        np.testing.assert_array_equal(got["k"].numpy(), np.asarray(want["k"]))
