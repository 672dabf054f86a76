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
