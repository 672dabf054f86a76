"""Fault draws and the quantized integer datapath of the port are bitwise
those of the reference (repro.core.faults / repro.core.quantization)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as JF
from repro.core import quantization as JQ
from repro_torch.core import faults as TF
from repro_torch.core import prng
from repro_torch.core import quantization as TQ

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

MASKS = (0, 0xC0, 0xFF, "per-channel")


def _assert_bitwise(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    assert (a == b).all(), (msg, np.argwhere(a != b)[:5])


def _mask(kind, n):
    if kind != "per-channel":
        return kind, kind
    m = np.random.default_rng(0).choice([0, 0x80, 0xE0, 0xFF], n
                                        ).astype(np.int32)
    return jnp.asarray(m), torch.from_numpy(m)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("ber", (0.0, 1e-2, 0.25))
def test_flip_word(ber, mask):
    """Static BER (float) as the reference draws it outside jit, with raw,
    residual and skipped residual planes."""
    jm, tm = _mask(mask, 24)
    want = JF.flip_word(jax.random.PRNGKey(4), (6, 24), ber, 8, jm)
    got = TF.flip_word(prng.PRNGKey(4), (6, 24), ber, 8, tm)
    _assert_bitwise(want, got.numpy(), f"ber={ber} mask={mask}")


@pytest.mark.parametrize("ber", (1e-3, 3e-3, 5e-2))
def test_flip_word_traced_ber_and_key_batch(ber):
    """A traced BER (the policy pytree's leaf inside jit) is float32
    arithmetic; a key batch is the reference's vmap over keys."""
    jm, tm = _mask("per-channel", 40)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3))
    want = jax.jit(jax.vmap(lambda k, b: JF.flip_word(k, (40,), b, 8, jm),
                            in_axes=(0, None)))(keys, jnp.float32(ber))
    got = TF.flip_word(prng.as_key(np.asarray(keys)), (40,),
                       torch.tensor(ber, dtype=torch.float32), 8, tm)
    _assert_bitwise(want, got.numpy())


def test_residual_ber_traced_is_float32():
    b = np.float32(3e-3)
    want = jax.jit(JF.residual_ber)(b)
    got = TF.residual_ber(torch.tensor(b))
    _assert_bitwise(np.asarray(want), got.numpy())
    assert np.float32(JF.residual_ber(3e-3)) == np.float32(
        TF.residual_ber(3e-3))


@pytest.mark.parametrize("signed", (True, False))
def test_flip_bits_and_injections(signed):
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, (5, 33)).astype(np.int32)
    k, kt = jax.random.PRNGKey(8), prng.PRNGKey(8)
    _assert_bitwise(JF.flip_bits(k, jnp.asarray(x), 0.1, 8, 0xE0, signed),
                    TF.flip_bits(kt, torch.from_numpy(x), 0.1, 8, 0xE0,
                                 signed).numpy())
    prot = rng.integers(0, 9, 33).astype(np.int32)
    _assert_bitwise(
        JF.inject_output_faults(k, jnp.asarray(x), 0.05,
                                protect_top=jnp.asarray(prot)),
        TF.inject_output_faults(kt, torch.from_numpy(x), 0.05,
                                protect_top=torch.from_numpy(prot)).numpy())
    _assert_bitwise(JF.inject_weight_faults(k, jnp.asarray(x), 0.05),
                    TF.inject_weight_faults(kt, torch.from_numpy(x),
                                            0.05).numpy())


def test_protect_mask_and_fold_stream():
    for top in range(-1, 10):
        assert JF.top_bits_mask(top, 8) == TF.top_bits_mask(top, 8)
        assert JF.protect_mask(top) == TF.protect_mask(top)
    p = np.arange(-2, 11, dtype=np.int32)
    _assert_bitwise(JF.protect_mask(jnp.asarray(p)),
                    TF.protect_mask(torch.from_numpy(p)).numpy())
    _assert_bitwise(JF.fold_stream(jax.random.PRNGKey(1), 3, 2**32 - 2),
                    TF.fold_stream(prng.PRNGKey(1), 3, 2**32 - 2).numpy()
                    .astype(np.uint32))


@pytest.mark.parametrize("axis", (None, 1))
def test_quantize(axis):
    x = (np.random.default_rng(2).standard_normal((7, 50)) * 3
         ).astype(np.float32)
    x[3] = 0.0                       # an all-zero row hits the 1e-8 floor
    qj, sj = JQ.quantize(jnp.asarray(x), axis=axis)
    qt, st = TQ.quantize(torch.from_numpy(x), axis=axis)
    _assert_bitwise(qj, qt.numpy())
    _assert_bitwise(sj, st.numpy())


def test_choose_trunc_lsb_and_truncate():
    a = np.array([0, 1, 2, 127, 128, 255, 256, 2**15, 2**20 + 3, 2**23 - 1,
                  2**23, -2**23, -5], np.int32)
    for qs in (0, 3, 9, 20):
        tj = JQ.choose_trunc_lsb(jnp.asarray(a), q_scale=qs)
        tt = TQ.choose_trunc_lsb(torch.from_numpy(a), q_scale=qs)
        _assert_bitwise(tj, tt.numpy(), f"q_scale={qs}")
        acc = np.random.default_rng(qs).integers(-2**23, 2**23, a.shape
                                                 ).astype(np.int32)
        _assert_bitwise(JQ.truncate_acc(jnp.asarray(acc), tj),
                        TQ.truncate_acc(torch.from_numpy(acc), tt).numpy())
    qs = torch.tensor(5, dtype=torch.int32)    # a dyn q_scale stays a tensor
    _assert_bitwise(JQ.choose_trunc_lsb(jnp.asarray(a), q_scale=5),
                    TQ.choose_trunc_lsb(torch.from_numpy(a), q_scale=qs)
                    .numpy())


@pytest.mark.parametrize("q_scale", (0, 6))
def test_qmatmul(q_scale):
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, (9, 300)).astype(np.int32)
    wq = rng.integers(-128, 128, (300, 70)).astype(np.int32)
    yj, tj = JQ.qmatmul(jnp.asarray(xq), jnp.asarray(wq), q_scale)
    yt, tt = TQ.qmatmul(torch.from_numpy(xq), torch.from_numpy(wq), q_scale)
    _assert_bitwise(yj, yt.numpy())
    _assert_bitwise(tj, tt.numpy())
