"""The port's threefry copy (repro_torch.core.prng) draws bitwise the same
bits as jax.random in partitionable mode, which importing
repro.core.faults switches on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.faults  # noqa: F401  (partitionable threefry, as the reference draws)
from repro_torch.core import prng

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

SEEDS = (0, 1, 42, 2**31 + 5, 2**32 + 7, -3)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _assert_bitwise(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    assert a.dtype == b.dtype, (msg, a.dtype, b.dtype)
    assert (a == b).all(), (msg, np.argwhere(a != b)[:5])


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    _assert_bitwise(jax.random.PRNGKey(seed), _np(prng.PRNGKey(seed)))


@pytest.mark.parametrize("num", (1, 2, 3, 16, 33))
def test_split(num):
    k = jax.random.PRNGKey(11)
    _assert_bitwise(jax.random.split(k, num), _np(prng.split(prng.PRNGKey(11),
                                                             num)))


def test_split_key_batch_is_vmap():
    ks = jax.vmap(jax.random.PRNGKey)(jnp.arange(5))
    want = jax.vmap(lambda k: jax.random.split(k, 3))(ks)
    _assert_bitwise(want, _np(prng.split(prng.as_key(np.asarray(ks)), 3)))


@pytest.mark.parametrize("data", (0, 1, 7, 2**31 - 1, 2**31, 2**32 - 1))
def test_fold_in(data):
    k = jax.random.PRNGKey(5)
    _assert_bitwise(jax.random.fold_in(k, data),
                    _np(prng.fold_in(prng.PRNGKey(5), data)))


def test_fold_in_key_batch_is_vmap():
    ks = jax.vmap(jax.random.PRNGKey)(jnp.arange(4))
    want = jax.vmap(lambda k: jax.random.fold_in(k, 3_000_000_000))(ks)
    _assert_bitwise(want, _np(prng.fold_in(prng.as_key(np.asarray(ks)),
                                           3_000_000_000)))


@pytest.mark.parametrize("shape", ((1,), (7,), (3, 5), (2, 3, 4), (1000,)))
def test_bits_and_uniform(shape):
    k, kt = jax.random.PRNGKey(9), prng.PRNGKey(9)
    _assert_bitwise(jax.random.bits(k, shape), _np(prng.bits(kt, shape)))
    _assert_bitwise(jax.random.uniform(k, shape), prng.uniform(kt, shape)
                    .numpy())


@pytest.mark.parametrize("p", (0.0, 1e-3, 0.3, 0.5, 1.0))
def test_bernoulli(p):
    k, kt = jax.random.PRNGKey(13), prng.PRNGKey(13)
    _assert_bitwise(jax.random.bernoulli(k, p, (4, 250)),
                    prng.bernoulli(kt, p, (4, 250)).numpy())


def test_bernoulli_traced_p():
    """A float32 tensor p is the reference's traced probability."""
    p = np.float32(3e-3)
    want = jax.jit(lambda q: jax.random.bernoulli(jax.random.PRNGKey(2), q,
                                                  (2000,)))(p)
    got = prng.bernoulli(prng.PRNGKey(2), torch.tensor(p), (2000,))
    _assert_bitwise(want, got.numpy())


def test_fold_in_tensor_data():
    """A (B,) vector folded into one key is vmap over the data; folded into
    a (B, 2) key batch it goes row by row (the Scheduler's per-request
    keys: request ids, then step indices, negative ones taken as uint32)."""
    base = jax.random.PRNGKey(21)
    rids = np.array([0, 7, 2**31, 2**32 - 1, 5], np.int64)
    steps = np.array([0, -1, 3, 1, 2**31 + 1], np.int64)
    want = jax.vmap(lambda r, t: jax.random.fold_in(
        jax.random.fold_in(base, r), t))(rids.astype(np.uint32),
                                         steps.astype(np.uint32))
    got = prng.fold_in(prng.fold_in(prng.PRNGKey(21), torch.from_numpy(rids)),
                       torch.from_numpy(steps))
    _assert_bitwise(want, _np(got))


@pytest.mark.parametrize("lo,hi", ((0., 1.), (-2., 3.), (1.5, 1.75),
                                   (1e-20, 3.), (-7.25, 1e-3),
                                   (float(np.finfo(np.float32).tiny), 1.)))
def test_uniform_range(lo, hi):
    k, kt = jax.random.PRNGKey(17), prng.PRNGKey(17)
    _assert_bitwise(jax.random.uniform(k, (3, 700), minval=lo, maxval=hi),
                    prng.uniform(kt, (3, 700), lo, hi).numpy())


def test_gumbel_within_two_ulp_per_log():
    """Stated tolerance: 2 float32 ulp at each of the two logs.  The uniform
    draw is bitwise; ``y = -log(u)`` and ``g = -log(y)`` are each
    framework's own float32 log, each within 1 ulp of exact, so the two may
    differ by 2 ulp of y, which the outer log carries into g as a relative
    2 ulp(y) / y, plus 2 ulp of g.  (Near g = 0 the first term is many ulp
    of g.)"""
    k, kt = jax.random.PRNGKey(19), prng.PRNGKey(19)
    want = np.asarray(jax.random.gumbel(k, (4, 5000)))
    got = prng.gumbel(kt, (4, 5000)).numpy()
    y = np.exp(-want.astype(np.float64)).astype(np.float32)
    tol = 2 * np.spacing(np.abs(want)) + 2 * np.spacing(y) / y
    assert (np.abs(got - want) <= tol).all()
    assert (got != want).any()       # the logs do differ: the bound is used


@pytest.mark.parametrize("seed", (0, 3, 2**31 + 1))
def test_categorical(seed):
    """One key over (4, 32000) logits, and a batch of one key per row (the
    Scheduler's vmap over requests)."""
    logits = np.random.default_rng(seed % 1000).standard_normal(
        (4, 32000)).astype(np.float32) * 3
    k = jax.random.PRNGKey(seed)
    got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.categorical(k, logits)))
    ks = jax.random.split(k, 4)
    got = prng.categorical(prng.as_key(np.asarray(ks)),
                           torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax.vmap(jax.random.categorical)(ks, logits)))


@pytest.mark.parametrize("lo,hi", ((0, 8), (0, 1), (-5, 1000), (3, 3),
                                   (5, 2), (-7, 70000),
                                   (0, 2**31 - 1), (-2**31, 2**31 - 1)))
def test_randint(lo, hi):
    """Bitwise (integer math): spans of one, a power of two, odd ones, an
    empty range (maxval <= minval gives minval), and spans past 2**16 and
    2**31, where jax's uint32 products wrap; one key and a key batch."""
    for seed in (0, 2**32 - 1):
        k = jax.random.PRNGKey(seed)
        _assert_bitwise(np.asarray(jax.random.randint(k, (3, 333), lo, hi)),
                        prng.randint(prng.PRNGKey(seed), (3, 333), lo, hi)
                        .numpy().astype(np.int32))
    ks = jax.random.split(jax.random.PRNGKey(4), 3)
    want = jax.vmap(lambda kk: jax.random.randint(kk, (50,), lo, hi))(ks)
    _assert_bitwise(np.asarray(want), prng.randint(
        prng.as_key(np.asarray(ks)), (50,), lo, hi).numpy().astype(np.int32))


# jax.random.normal is sqrt(2) * erf_inv(u): prng.erfinv is XLA's polynomial
# with its Horner steps fused, but log1p is each framework's own, so a draw
# may part by a few float32 ulps (3 at most over 2e6 draws, 1% differ)
NORMAL_ULPS = 3


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(np.where(a < 0, -(a & 0x7FFFFFFF), a)
                  - np.where(b < 0, -(b & 0x7FFFFFFF), b))


@pytest.mark.parametrize("seed", (0, 99, 2**31 + 5))
def test_normal_within_stated_ulps(seed):
    k = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(k, (8, 16, 16, 1)))
    got = prng.normal(prng.PRNGKey(seed), (8, 16, 16, 1)).numpy()
    assert _ulps(want, got).max() <= NORMAL_ULPS
    assert (got != want).any()       # the draws do differ: the bound is used
    ks = jax.random.split(k, 3)
    want = jax.vmap(lambda kk: jax.random.normal(kk, (700,)))(ks)
    got = prng.normal(prng.as_key(np.asarray(ks)), (700,)).numpy()
    assert _ulps(np.asarray(want), got).max() <= NORMAL_ULPS


def test_erfinv_ends_and_middle():
    """erf_inv's edges as XLA's: +-inf at +-1, 0 at 0, and within the
    stated ulps elsewhere (u from the normal sampler's range)."""
    u = np.array([-1.0, 1.0, 0.0, np.nextafter(np.float32(-1), np.float32(0)),
                  0.5, -0.9999, 0.99999994, 1e-30, -3e-8], np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    got = prng.erfinv(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got[:3], want[:3])
    assert _ulps(want[3:], got[3:]).max() <= NORMAL_ULPS
