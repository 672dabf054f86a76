"""The port's DLA kernel triplets (qmatmul, fault_inject, protected_mm) and
the pallas backend of protect_linear against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages; the JAX kernels
run in Pallas interpret mode, as tests/test_kernels.py runs them, and the
port's launchers take their plain versions (CPU tensors).  Every integer
result is held bitwise.  Float results are held bitwise where the reference
computes its rescale ``yq * (sx * sw * 2**t)`` op by op: protect_linear's
pallas backend (eager in the reference outside jit), and quant_linear and
ft_linear_fused run under jax.disable_jit.  The latter two are jitted in the
reference, and there their y is within MAX_ULP of the port's (2 ulp
observed): XLA reassociates the rescale's constant divisions (max|x|/127 *
max|w|/127 -> max|x| * (max|w| * 1/127^2)), and each of those roundings
moves y by at most half an ulp; the zero pattern, which the integers set,
is equal.  (tests/test_torch_fused_decode.py found the same of the fused
backend.)

The CUDA kernels themselves are held to the plain versions on the card, in
tests/test_torch_gpu.py and chip_smoke.py.  What their design rests on is
held here in plain math: the GEMM of protected_mm and qmatmul adds int32
partials over the launch plan's K chunks (kernel.gemm_plan, the plan the
launcher is given) and saturates only the total, which gives
protected_mm_ref and qmatmul_ref bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ft as jft
from repro.kernels.fault_inject.kernel import fault_inject as jax_fault_inject
from repro.kernels.fault_inject.ops import inject as jax_inject
from repro.kernels.fault_inject.ops import random_planes as jax_random_planes
from repro.kernels.fault_inject.ref import inject_ref as jax_inject_ref
from repro.kernels.protected_mm.kernel import protected_mm as jax_protected_mm
from repro.kernels.protected_mm.ops import calibrate_t as jax_calibrate_t
from repro.kernels.protected_mm.ops import \
    ft_linear_fused as jax_ft_linear_fused
from repro.kernels.protected_mm.ref import \
    protected_mm_ref as jax_protected_mm_ref
from repro.kernels.qmatmul.kernel import qmatmul as jax_qmatmul
from repro.kernels.qmatmul.ops import quant_linear as jax_quant_linear
from repro.kernels.qmatmul.ref import qmatmul_ref as jax_qmatmul_ref
from repro_torch import ft as tft
from repro_torch.core import prng
from repro_torch.core import quantization as Q
from repro_torch.kernels import plan as tplan
from repro_torch.kernels.fault_inject import kernel as fi_kernel
from repro_torch.kernels.fault_inject import ops as fi_ops
from repro_torch.kernels.fault_inject.ref import inject_ref, threshold
from repro_torch.kernels.protected_mm import kernel as pm_kernel
from repro_torch.kernels.protected_mm import ops as pm_ops
from repro_torch.kernels.protected_mm.ref import protected_mm_ref
from repro_torch.kernels.qmatmul import kernel as qm_kernel
from repro_torch.kernels.qmatmul import ops as qm_ops
from repro_torch.kernels.qmatmul.ref import qmatmul_ref

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

POLICIES = ("base", "crt1", "crt2", "crt3", "arch", "alg", "cl")
MAX_ULP = 4


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), msg)


def _eq_jitted(jitted_fn, got, *args, **kw):
    """``got`` bitwise equal to ``jitted_fn`` run op by op, and within
    MAX_ULP of it jitted."""
    with jax.disable_jit():
        _eq(got, jitted_fn(*args, **kw), "op by op")
    want = np.asarray(jitted_fn(*args, **kw))
    got = np.asarray(got)
    assert ((got == 0) == (want == 0)).all()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64)).max()
    assert ulp <= MAX_ULP, ulp


def _i8(rng, *shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _planes(rng, *shape):
    """uint32 planes with words near 0 and near 2**32 - 1 mixed in, so BER
    1e-2 flips bits and the unsigned comparison sees words >= 2**31."""
    words = rng.integers(0, 1 << 32, shape, dtype=np.uint64)
    low = rng.random(shape) < 0.05
    words[low] = rng.integers(0, 1 << 26, int(low.sum()), dtype=np.uint64)
    return words.astype(np.uint32)


def _t64(a):
    """A uint32 numpy array as the port's int64 words."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------- qmatmul --
@pytest.mark.parametrize("t", (0, 3, 16))
def test_qmatmul_matches_pallas_and_jax_ref(t):
    rng = np.random.default_rng(t)
    x, w = _i8(rng, 128, 384), _i8(rng, 384, 256)
    want = np.asarray(jax_qmatmul(jnp.asarray(x), jnp.asarray(w), t))
    _eq(want, jax_qmatmul_ref(jnp.asarray(x), jnp.asarray(w), t))
    got = qmatmul_ref(torch.from_numpy(x), torch.from_numpy(w), t)
    assert got.dtype == torch.int8
    _eq(got, want, f"t={t}")
    _eq(qm_kernel.qmatmul(torch.from_numpy(x), torch.from_numpy(w), t),
        want)


@pytest.mark.parametrize("t", (0, 16))
def test_qmatmul_saturation_matches(t):
    """tests/test_kernels.py's case, at K = 640 so that 127 x 127 and
    127 x -128 over K exceed 2**23 and the 24-bit saturation binds at both
    ends (then the int8 clamp at t = 0)."""
    x = np.full((128, 640), 127, np.int8)
    w = np.full((640, 128), 127, np.int8)
    w[:, 1] = -128
    want = np.asarray(jax_qmatmul(jnp.asarray(x), jnp.asarray(w), t))
    got = qmatmul_ref(torch.from_numpy(x), torch.from_numpy(w), t)
    _eq(got, want)
    if t == 16:     # (2**23 - 1 + 2**15) >> 16 = 128 clamps to 127
        assert int(got[0, 0]) == 127 and int(got[0, 1]) == -128


def test_quant_linear_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((128, 128)).astype(np.float32)
    w = rng.standard_normal((128, 128)).astype(np.float32)
    t = jax_calibrate_t(jnp.asarray(x), jnp.asarray(w), q_scale=0)
    assert t == pm_ops.calibrate_t(torch.from_numpy(x), torch.from_numpy(w),
                                   q_scale=0)
    got = qm_ops.quant_linear(torch.from_numpy(x), torch.from_numpy(w), t)
    _eq_jitted(jax_quant_linear, got, jnp.asarray(x), jnp.asarray(w), t)


# ----------------------------------------------------------- fault_inject --
@pytest.mark.parametrize("ber", (0.0, 1e-2, 1.0))
def test_inject_ref_matches_pallas_at_any_protect(ber):
    """protect -1, 0, 3, 8 and 9 mixed within every group of 4 columns (the
    CUDA kernel's unit) at N = 130, not a multiple of 4: a negative count
    exposes every bit, 8 or more none.  The Pallas kernel takes the whole
    row as its block (N is not a multiple of 128)."""
    rng = np.random.default_rng(int(ber * 100) + 7)
    x = rng.integers(-128, 128, (16, 130)).astype(np.int32)
    rnd = _planes(rng, 8, 16, 130)
    prot = np.array((-1, 0, 3, 8, 9), np.int32)[np.arange(130) % 5]
    want = np.asarray(jax_fault_inject(jnp.asarray(x), jnp.asarray(rnd),
                                       jnp.asarray(prot), ber, bn=130))
    tx, tp = torch.from_numpy(x), torch.from_numpy(prot)
    got = inject_ref(tx, _t64(rnd), tp, ber)
    _eq(got, want, f"ber={ber}")
    _eq(fi_kernel.fault_inject(tx, prng.as_int32_bits(_t64(rnd)), tp, ber),
        want)
    _eq(got.numpy()[:, prot >= 8], x[:, prot >= 8])
    if ber == 1.0:      # every bit of protect -1 and 0 flips
        _eq((got.numpy()[:, prot <= 0] ^ x[:, prot <= 0]) & 0xFF,
            np.full_like(x[:, prot <= 0], 0xFF))


@pytest.mark.parametrize("ber", (0.0, 1e-2, 1.0))
def test_inject_ref_matches_pallas(ber):
    """protect 0..8 across the columns; the planes as int64 words and as
    their int32 bit patterns give the same result.  Row 0's words are all
    2**32 - 1, which no threshold passes, not even BER 1.0's."""
    rng = np.random.default_rng(int(ber * 100) + 1)
    x = rng.integers(-128, 128, (64, 128)).astype(np.int32)
    rnd = _planes(rng, 8, 64, 128)
    rnd[:, 0] = 0xFFFFFFFF
    prot = (np.arange(128) % 9).astype(np.int32)
    want = np.asarray(jax_fault_inject(jnp.asarray(x), jnp.asarray(rnd),
                                       jnp.asarray(prot), ber))
    _eq(want, jax_inject_ref(jnp.asarray(x), jnp.asarray(rnd),
                             jnp.asarray(prot), ber))
    tx, tp = torch.from_numpy(x), torch.from_numpy(prot)
    got = inject_ref(tx, _t64(rnd), tp, ber)
    assert got.dtype == torch.int32
    _eq(got, want, f"ber={ber}")
    _eq(fi_kernel.fault_inject(tx, prng.as_int32_bits(_t64(rnd)), tp, ber),
        want)
    if ber == 0.0:
        _eq(got, x)
    if ber == 1.0:      # every unprotected bit flips, but in row 0
        keep = (0xFF << (8 - prot)) & 0xFF
        _eq((got.numpy()[1:] ^ x[1:]) & 0xFF,
            np.broadcast_to(~keep & 0xFF, x[1:].shape))
        _eq(got[0], x[0])


def test_threshold_clamps_and_rounds_as_the_reference():
    assert threshold(0.0) == 0
    assert threshold(1.0) == (1 << 32) - 1
    assert threshold(1e-4) == int(1e-4 * (1 << 32))
    assert threshold(np.float32(1e-4)) == int(float(np.float32(1e-4))
                                              * (1 << 32))


def test_as_int32_bits_wraps_the_high_words():
    words = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    _eq(prng.as_int32_bits(words),
        np.array([0, 1, (1 << 31) - 1, -(1 << 31), -1], np.int32))


def test_random_planes_match_jax_at_a_padded_shape():
    key = jax.random.PRNGKey(17)
    want = np.asarray(jax_random_planes(key, (128, 256)))
    got = fi_ops.random_planes(prng.as_key(np.asarray(key)), (128, 256))
    assert got.shape == (8, 128, 256)
    _eq(got, want.astype(np.int64))


def test_inject_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, (256, 128)).astype(np.int32)
    prot = (np.arange(128) % 9).astype(np.int32)
    key = jax.random.PRNGKey(9)
    want = jax_inject(key, jnp.asarray(x), jnp.asarray(prot), ber=0.1)
    got = fi_ops.inject(prng.as_key(np.asarray(key)), torch.from_numpy(x),
                        torch.from_numpy(prot), 0.1)
    _eq(got, want)
    assert (got.numpy() != x).any()


# ----------------------------------------------------------- protected_mm --
# (M, K, N) whose launch plans split K: decode (5 chunks), prefill (7
# chunks), prefill with a chunk deep enough for a partial past 2**23 (2
# chunks of 3456), and K under one 64-step (one chunk)
SPLIT_SHAPES = ((4, 2560, 6912), (256, 2560, 640), (256, 6912, 2560),
                (1, 31, 130))


def _split_matmul(chunks, saturate_each=False):
    """``Q.int_matmul`` as the kernel's GEMM computes it: the int32
    partials of the plan's K chunks, added (each saturated first, when
    asked, to show why the kernel does not)."""
    def int_matmul(a, b):
        a, b = a.numpy().astype(np.int64), b.numpy().astype(np.int64)
        parts = [a[:, k0:k1] @ b[k0:k1] for k0, k1 in chunks]
        if saturate_each:
            parts = [Q.saturate(torch.from_numpy(p)).numpy() for p in parts]
        total = sum(parts)
        assert np.abs(total).max() < 1 << 31
        return torch.from_numpy(total.astype(np.int32))
    return int_matmul


def _split_cases(rng, mm, nn, x, w):
    """{kernel: (its launcher's module, its plain version on x and w)}:
    protected_mm at t = 13, BER 1e-2 and a mixed mask; qmatmul at t =
    13."""
    args = (torch.from_numpy(x), torch.from_numpy(w),
            prng.as_int32_bits(_t64(_planes(rng, 8, mm, nn))),
            prng.as_int32_bits(_t64(_planes(rng, 8, mm, nn))),
            torch.from_numpy((rng.random(nn) < 0.4).astype(np.int32)))
    return {"protected_mm": (pm_kernel, lambda: protected_mm_ref(
                *args, t=13, ber=1e-2, ib=2, nb=1)),
            "qmatmul": (qm_kernel, lambda: qmatmul_ref(*args[:2], 13))}


@pytest.mark.parametrize("kernel", ("protected_mm", "qmatmul"))
@pytest.mark.parametrize("mkn", SPLIT_SHAPES)
def test_split_k_sum_is_the_plain_version(monkeypatch, mkn, kernel):
    """The launch plan's K chunks cover K once, in 64-aligned chunks of at
    most MAX_SPLITS; the kernel's plain version (protected_mm_ref, or
    qmatmul_ref) whose product is the sum of the chunks' int32 partials,
    saturated afterwards, equals it bitwise.  Where a chunk is deep
    enough, row 0 against column 0 has a first partial past 2**23 and a
    total of about 2**20, and saturating each partial gives another y."""
    m, k, n = mkn
    plan = pm_kernel.gemm_plan(m, k, n)
    assert qm_kernel.gemm_plan(m, k, n) == plan
    chunks = plan.k_chunks(k)
    assert [c for k0, k1 in chunks for c in range(k0, k1)] == list(range(k))
    assert plan.kc % tplan.BK == 0 and len(chunks) <= tplan.MAX_SPLITS
    assert all(k1 > k0 for k0, k1 in chunks)
    rng = np.random.default_rng(k)
    mm, nn = min(m, 6), min(n, 12)
    x, w = _i8(rng, mm, k), _i8(rng, k, nn)
    straddles = len(chunks) > 1 and 127 * 127 * plan.kc > 1 << 23
    if straddles:
        x[0] = 127
        w[:plan.kc, 0], w[plan.kc:, 0] = 127, -127
        w[plan.kc:plan.kc + 64, 0] = 0
        x0, w0 = x[0].astype(np.int64), w[:, 0].astype(np.int64)
        assert x0[:plan.kc] @ w0[:plan.kc] > 1 << 23 > abs(x0 @ w0)
    plain = _split_cases(rng, mm, nn, x, w)[kernel][1]
    want = plain()
    with monkeypatch.context() as mp:
        mp.setattr(Q, "int_matmul", _split_matmul(chunks))
        got = plain()
        mp.setattr(Q, "int_matmul", _split_matmul(chunks, True))
        per_split = plain()
    _eq(got, want)
    if straddles:
        assert not torch.equal(per_split, want)


@pytest.mark.parametrize("t,ber,ib,nb", (
    (0, 0.0, 2, 1), (3, 1e-2, 2, 1), (16, 1e-2, 8, 0), (5, 1.0, 0, 8),
    (7, 1.0, 3, 3), (1, 1e-2, 0, 0)))
def test_protected_mm_matches_pallas_and_jax_ref(t, ber, ib, nb):
    rng = np.random.default_rng(100 + t)
    x, w = _i8(rng, 128, 256), _i8(rng, 256, 128)
    ro, ri = _planes(rng, 8, 128, 128), _planes(rng, 8, 128, 128)
    imp = (rng.random(128) < 0.3).astype(np.int32)
    jargs = tuple(map(jnp.asarray, (x, w, ro, ri, imp)))
    kw = dict(t=t, ber=ber, ib=ib, nb=nb)
    want = np.asarray(jax_protected_mm(*jargs, **kw))
    _eq(want, jax_protected_mm_ref(*jargs, **kw))
    targs = (torch.from_numpy(x), torch.from_numpy(w), _t64(ro), _t64(ri),
             torch.from_numpy(imp))
    got = protected_mm_ref(*targs, **kw)
    assert got.dtype == torch.int8
    _eq(got, want, str(kw))
    _eq(pm_kernel.protected_mm(*targs[:2], prng.as_int32_bits(targs[2]),
                               prng.as_int32_bits(targs[3]), targs[4], **kw),
        want)


@pytest.mark.parametrize("ber", (0.0, 0.02))
def test_ft_linear_fused_matches_jax(ber):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((128, 128)).astype(np.float32)
    w = rng.standard_normal((128, 128)).astype(np.float32)
    imp = rng.random(128) < 0.2
    t = jax_calibrate_t(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert t == pm_ops.calibrate_t(tx, tw)
    key = jax.random.PRNGKey(5)
    got = pm_ops.ft_linear_fused(prng.as_key(np.asarray(key)), tx, tw,
                                 torch.from_numpy(imp), t=t, ber=ber)
    if ber == 0.0:      # no fault: quant_linear's result
        _eq(got, qm_ops.quant_linear(tx, tw, t))
    else:
        _eq_jitted(jax_ft_linear_fused, got, key, jnp.asarray(x),
                   jnp.asarray(w), jnp.asarray(imp), t=t, ber=ber)


# --------------------------------------------- protect_linear, pallas ---
def _pallas_case(policy_name, t, layer_protected):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 200)).astype(np.float32)
    w = rng.standard_normal((200, 130)).astype(np.float32)
    imp = rng.random(130) < 0.3
    key = jax.random.PRNGKey(21)
    want = jft.protect_linear(
        key, jnp.asarray(x), jnp.asarray(w),
        jft.get_policy(policy_name, ber=1e-2), jnp.asarray(imp),
        layer_protected=layer_protected, backend="pallas", t=t)
    got = tft.protect_linear(
        prng.as_key(np.asarray(key)), torch.from_numpy(x),
        torch.from_numpy(w), tft.get_policy(policy_name, ber=1e-2),
        torch.from_numpy(imp), layer_protected=layer_protected,
        backend="pallas", t=t)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("policy_name", POLICIES)
def test_protect_linear_pallas_matches_jax(policy_name):
    """5 x 200 x 130: the reference pads every operand to 128 and draws its
    planes over the padded (128, 256) output; the port draws the same shape
    and keeps the corner.  t given and calibrated; layer_protected both
    ways for the whole-layer-TMR policies."""
    cases = [(4, True), (None, True)]
    if policy_name in ("arch", "alg"):
        cases.append((None, False))
    for t, lp in cases:
        want, got = _pallas_case(policy_name, t, lp)
        _eq(got, want, f"{policy_name} t={t} layer_protected={lp}")


def test_protect_linear_pallas_refusals():
    x, w = torch.zeros(4, 8), torch.zeros(8, 6)
    pol = tft.get_policy("crt3", ber=1e-2)
    with pytest.raises(ValueError, match="per-row key batches"):
        tft.protect_linear(prng.split(prng.PRNGKey(0), 4), x, w, pol,
                           backend="pallas")
    with pytest.raises(ValueError, match="dyn knob overrides"):
        tft.protect_linear(prng.PRNGKey(0), x, w, pol, backend="pallas",
                           dyn={"q_scale": 3})
    with pytest.raises(ValueError, match="unknown backend"):
        tft.protect_linear(prng.PRNGKey(0), x, w, pol, backend="tpu")
    assert tft.BACKENDS == jft.BACKENDS
    for name in POLICIES:
        assert (tft.get_policy(name).uses_importance
                == jft.get_policy(name).uses_importance)


def test_calibrate_t_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 96)).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32) * 0.01
    for q in (0, 7, 20):
        assert (tft.calibrate_t(torch.from_numpy(x), torch.from_numpy(w),
                                q_scale=q)
                == jft.calibrate_t(jnp.asarray(x), jnp.asarray(w),
                                   q_scale=q))
