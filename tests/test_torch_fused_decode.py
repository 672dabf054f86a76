"""The port's fused_decode triplet against the reference.

  * The plain version (repro_torch.kernels.fused_decode.ref.fused_ref, which
    kernel.fused_decode runs for CPU tensors) is bitwise equal to the Pallas
    kernel in interpret mode and to the reference's fused_ref, on the same
    integer operands, over five K blocks, in every valid mode, on random
    operands and on operands that drive the clamps (24-bit saturation, t's
    upper clamp of 16, q_scale above the natural t).
  * protect_linear, both port backends, against the reference's
    protect_linear(backend="reference") for all 7 registry policies:
    - run op by op (jax.disable_jit), the reference's integer outputs yq
      and truncation LSB t, and its float y, equal the port's bitwise;
    - jitted, its float y is within 4 ulp of the port's (2 ulp observed
      with per-row keys, 0 with one key, under every policy):
      XLA reassociates the rescale sx*sw*2^t, whose scales carry constant
      divisions (max|x|/127 * max|w|/127 -> max|x| * (max|w| * 1/127^2)),
      and each of those three roundings moves y by at most half an ulp.
      Quantization and rescale, the only float steps, are the same
      expressions under every policy, so cl's two cases (one key, per-row
      keys) hold the jitted path; each jitted case costs a compile.
  * The port's fused backend equals its reference backend bitwise, in its
    integers and in y.
  * The CUDA kernel's one invariant, in plain math: its GEMM adds int32
    partials over the launch plan's K chunks (kernel.gemm_plan, the plan the
    launcher is given) and saturates only the total; the chunks cover K
    once, and fused_ref with its product computed that way is fused_ref.
    Saturating each partial instead would differ where a partial passes
    2**23 and the total does not.

The CUDA kernel itself is held to the plain version on the card, in
tests/test_torch_gpu.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ft as jft
from repro.ft import api as japi
from repro.kernels.fused_decode.kernel import fused_decode as pallas_fused
from repro.kernels.fused_decode.ref import fused_ref as jax_fused_ref
from repro_torch import ft as tft
from repro_torch.core import prng
from repro_torch.core import quantization as Q
from repro_torch.kernels import plan as tplan
from repro_torch.kernels.fused_decode import kernel as tkernel
from repro_torch.kernels.fused_decode import ops as tops
from repro_torch.kernels.fused_decode.ref import fused_ref

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

POLICIES = ("base", "crt1", "crt2", "crt3", "arch", "alg", "cl")
MAX_ULP = 4
SHAPE = (8, 640, 128)       # (M, K, N): five 128-deep K blocks
# (per_row, dppu_src, perrow_wf): with per-row weight flips the recompute
# reads the clean weights ("w" or "wcl"), never the row-private accumulator
MODES = ([(pr, d, False) for pr in (False, True)
          for d in ("none", "reuse", "w", "wcl")]
         + [(pr, d, True) for pr in (False, True) for d in ("none", "w", "wcl")])


def _assert_bitwise(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    assert (a == b).all(), (msg, np.argwhere(a != b)[:5])


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)

    def words(*s):
        return (rng.integers(0, 256, s) * (rng.random(s) < 0.2)
                ).astype(np.int32)
    return dict(
        xq=rng.integers(-128, 128, (m, k)).astype(np.int8),
        wq=rng.integers(-128, 128, (k, n)).astype(np.int8),
        wq_clean=rng.integers(-128, 128, (k, n)).astype(np.int8),
        oflips=words(m, n), dflips=words(m, n), wflips=words(m, k, n),
        imp=(rng.random(n) < 0.4).astype(np.int32))


def _mode_args(ops, dppu_src, perrow_wf):
    kw = {}
    if dppu_src != "none":
        kw["dflips"], kw["imp"] = ops["dflips"], ops["imp"]
    if dppu_src == "wcl":
        kw["wq_clean"] = ops["wq_clean"]
    if perrow_wf:
        kw["wflips"] = ops["wflips"]
    return kw


def _edges(ops):
    """Sign-correlated rows and columns that drive the clamps: rows of 127
    and of -128 against columns of 127 and of -128 reach |acc| = 127*128*K
    > 2**23 once K > 516, so the 24-bit saturation fires at both ends and
    those rows' t reaches its upper clamp of 16; a zero row (t = 0) and a
    row of -1/0/1 (small t) sit below a large q_scale.  (Saturating at 24
    bits looks the same as not saturating, as t <= 16 puts the 8-bit
    window's own clamp below 2**23; a narrower saturation would show.)"""
    xq, wq = ops["xq"], ops["wq"]
    xq[0], xq[1], xq[2] = 127, -128, 0
    xq[3] = xq[3] % 3 - 1
    wq[:, 0], wq[:, 1], wq[:, 2] = 127, -128, 0
    return ops


@pytest.mark.parametrize("per_row,dppu_src,perrow_wf", MODES)
def test_plain_matches_pallas_and_jax_ref(per_row, dppu_src, perrow_wf):
    """Random operands over five K blocks at q_scale 2 (the shape of the
    clamp cases below, so each mode's interpret-mode kernel compiles
    once)."""
    seed = MODES.index((per_row, dppu_src, perrow_wf))
    _check_plain(_operands(*SHAPE, seed=seed), (2,), per_row, dppu_src,
                 perrow_wf)


@pytest.mark.parametrize("per_row,dppu_src,perrow_wf", MODES)
def test_plain_matches_pallas_and_jax_ref_at_the_clamps(per_row, dppu_src,
                                                        perrow_wf):
    """Over five K blocks, operands that saturate the accumulator and pin t
    to 16 or to q_scale (12, or 20: above 16, which checks the clamps'
    order)."""
    seed = MODES.index((per_row, dppu_src, perrow_wf))
    ops = _edges(_operands(*SHAPE, seed=seed))
    acc = ops["xq"].astype(np.int64) @ ops["wq"].astype(np.int64)
    assert acc.max() >= 1 << 23 and acc.min() < -(1 << 23)
    for q_scale, tt in zip((0, 12, 20), _check_plain(
            ops, (0, 12, 20), per_row, dppu_src, perrow_wf)):
        if q_scale == 20:
            assert (tt == 16).all()
        elif per_row and not perrow_wf:
            assert tt[0, 0] == tt[1, 0] == 16 and tt[2, 0] == q_scale


# (M, K, N) whose launch plans split K: decode (8 chunks), prefill with a
# chunk deep enough for a partial past 2**23 (2 chunks of 3456), a ragged
# last chunk (2561 = 13 x 192 + 65), and K under one 64-step (one chunk)
SPLIT_SHAPES = ((4, 2560, 640), (256, 6912, 2560), (17, 2561, 130),
                (16, 31, 648), (4, 16384, 2048), (1280, 16384, 2048))


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


def _straddle(xq, wq, kc):
    """Row 0 against column 0: the first chunk's partial 127 * 127 * kc
    (> 2**23 once kc > 520), the second's -127 * 127 * (kc - 64), the
    later chunks' 0, so the total is 127 * 127 * 64 (about 2**20)."""
    xq[0] = 127
    wq[:, 0] = 0
    wq[:kc, 0], wq[kc:2 * kc - 64, 0] = 127, -127


@pytest.mark.parametrize("mkn", SPLIT_SHAPES)
def test_split_k_sum_is_the_plain_version(monkeypatch, mkn):
    """The launch plan's K chunks cover K once, in 64-aligned chunks of at
    most MAX_SPLITS; fused_ref whose product is the sum of the chunks'
    int32 partials, saturated afterwards, equals fused_ref bitwise, global
    and per-row t.  The chunking depends on K alone, so a few rows and
    columns at the full K stand for the shape."""
    m, k, n = mkn
    plan = tkernel.gemm_plan(m, k, n)
    chunks = plan.k_chunks(k)
    assert [c for k0, k1 in chunks for c in range(k0, k1)] == list(range(k))
    assert plan.kc % tplan.BK == 0 and len(chunks) <= tplan.MAX_SPLITS
    assert all(k1 > k0 for k0, k1 in chunks)
    ops = _operands(min(m, 6), k, min(n, 12), seed=k)
    straddles = (len(chunks) > 1 and 127 * 127 * plan.kc > 1 << 23
                 and chunks[1][1] - chunks[1][0] >= plan.kc - 64)
    if straddles:
        _straddle(ops["xq"], ops["wq"], plan.kc)
    x, w, oflips = (torch.from_numpy(ops[a]) for a in ("xq", "wq", "oflips"))
    for per_row in (False, True):
        want = fused_ref(x, w, oflips, 2, per_row=per_row)
        with monkeypatch.context() as mp:
            mp.setattr(Q, "int_matmul", _split_matmul(chunks))
            got = fused_ref(x, w, oflips, 2, per_row=per_row)
            mp.setattr(Q, "int_matmul", _split_matmul(chunks, True))
            per_split = fused_ref(x, w, oflips, 2, per_row=per_row)
        _assert_bitwise(got[0], want[0], f"y per_row={per_row}")
        _assert_bitwise(got[1], want[1], f"t per_row={per_row}")
        if straddles:
            assert not torch.equal(per_split[0], want[0])
    if straddles:
        x0, w0 = ops["xq"][0].astype(np.int64), ops["wq"][:, 0].astype(np.int64)
        assert x0[:plan.kc] @ w0[:plan.kc] > 1 << 23 > abs(x0 @ w0)


def _check_plain(ops, q_scales, per_row, dppu_src, perrow_wf):
    """Port fused_ref == jax fused_ref == Pallas (interpret) == the port's
    kernel entry on CPU tensors, at each q_scale; returns the port's t."""
    m, n = ops["xq"].shape[0], ops["wq"].shape[1]
    kw = _mode_args(ops, dppu_src, perrow_wf)
    jkw = {a: jnp.asarray(v) for a, v in kw.items()}
    if "imp" in jkw:
        jkw["imp"] = jkw["imp"].reshape(1, n)
    jrkw = dict(jkw)
    if dppu_src == "reuse":             # jax fused_ref recomputes from wq
        jrkw.pop("wq_clean", None)
    if "imp" in jrkw:
        jrkw["imp"] = jrkw["imp"].reshape(n)
    tkw = {a: torch.from_numpy(v) for a, v in kw.items()}
    xq, wq, oflips = (ops[a] for a in ("xq", "wq", "oflips"))
    ts = []
    for q_scale in q_scales:
        yp, tp = pallas_fused(jnp.asarray(xq), jnp.asarray(wq),
                              jnp.asarray(oflips),
                              jnp.full((1, 1), q_scale, jnp.int32),
                              per_row=per_row, dppu_src=dppu_src,
                              perrow_wf=perrow_wf, interpret=True, **jkw)
        yj, tj = jax_fused_ref(jnp.asarray(xq), jnp.asarray(wq),
                               jnp.asarray(oflips), q_scale, per_row=per_row,
                               **jrkw)
        yt, tt = fused_ref(torch.from_numpy(xq), torch.from_numpy(wq),
                           torch.from_numpy(oflips), q_scale,
                           per_row=per_row, **tkw)
        msg = f"q_scale={q_scale}"
        _assert_bitwise(np.asarray(yj), yt.numpy(), "y vs jax fused_ref " + msg)
        _assert_bitwise(np.asarray(tj), tt.numpy(), "t vs jax fused_ref " + msg)
        _assert_bitwise(np.asarray(yp), yt.numpy().astype(np.int8),
                        "y vs pallas " + msg)
        _assert_bitwise(np.asarray(tp).reshape(-1),
                        np.broadcast_to(tt.numpy().reshape(-1, 1), (m, 1))
                        .reshape(-1), "t vs pallas " + msg)
        # kernel.fused_decode on CPU tensors is the plain version, in the
        # kernel's output format
        yk, tk = tkernel.fused_decode(
            torch.from_numpy(xq), torch.from_numpy(wq),
            torch.from_numpy(oflips),
            torch.tensor([q_scale], dtype=torch.int32), per_row=per_row,
            dppu_src=dppu_src, perrow_wf=perrow_wf, **tkw)
        _assert_bitwise(np.asarray(yp), yk.numpy(), "cpu entry y " + msg)
        _assert_bitwise(np.asarray(tp), tk.numpy(), "cpu entry t " + msg)
        ts.append(tt.numpy())
    return ts


def _ulp_distance(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # map sign-magnitude float bits onto a monotone integer line
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _jax_op_by_op(monkeypatch, *args, **kw):
    """The reference backend run op by op, with the integers it computes:
    t and the scales sx, sw are read as they are made, and yq is recovered
    exactly from y = float32(yq) * (sx * sw * 2^t), as |yq| <= 128."""
    seen = {"scales": []}

    def quantize(*a, **k):
        q, scale = real.quantize(*a, **k)
        seen["scales"].append(np.asarray(scale))
        return q, scale

    def choose_trunc_lsb(*a, **k):
        seen["t"] = real.choose_trunc_lsb(*a, **k)
        return seen["t"]
    real = japi.Q
    with monkeypatch.context() as mp, jax.disable_jit():
        mp.setattr(japi, "Q", types.SimpleNamespace(
            **{**vars(real), "quantize": quantize,
               "choose_trunc_lsb": choose_trunc_lsb}))
        y = np.asarray(jft.protect_linear(*args, **kw))
    sx, sw = seen["scales"]
    t = np.asarray(seen["t"])
    scale = sx * sw * np.float32(2.0) ** t.astype(np.float32)
    ratio = y.astype(np.float64) / scale.astype(np.float64)
    yq = np.rint(ratio)
    assert np.abs(ratio - yq).max() < 1e-3
    return y, yq.astype(np.int32), t


def _case(monkeypatch, policy_name, per_row, weight_faults, m=5, k=200,
          n=130, seed=0, jit=False):
    """(reference op by op: y, yq, t; reference jitted: y or None;
    port: {backend: (y, yq, t)})."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    imp = rng.random(n) < 0.3
    if per_row:
        jkey = jax.vmap(jax.random.PRNGKey)(jnp.arange(100, 100 + m))
    else:
        jkey = jax.random.PRNGKey(11 + seed)
    jpol = jft.get_policy(policy_name, ber=1e-2, weight_faults=weight_faults)
    jargs = (jkey, jnp.asarray(x), jnp.asarray(w), jpol, jnp.asarray(imp))
    jdyn = {"dyn": {"q_scale": jnp.asarray(3, jnp.int32)}}
    op = _jax_op_by_op(monkeypatch, *jargs, **jdyn)
    jitted = np.asarray(jft.protect_linear(*jargs, **jdyn)) if jit else None

    tpol = tft.get_policy(policy_name, ber=1e-2, weight_faults=weight_faults)
    targs = (prng.as_key(np.asarray(jkey)), torch.from_numpy(x),
             torch.from_numpy(w), tpol, torch.from_numpy(imp))
    dyn = {"q_scale": torch.tensor(3, dtype=torch.int32)}
    seen = []

    def rescale(yq, sx, sw, t):
        seen.append((yq.numpy(), t.numpy()))
        return real_rescale(yq, sx, sw, t)
    real_rescale = tops.rescale
    got = {}
    with monkeypatch.context() as mp:
        mp.setattr(tops, "rescale", rescale)
        for b in ("reference", "fused"):
            y = tft.protect_linear(*targs, backend=b, dyn=dyn).numpy()
            got[b] = (y, *seen.pop())
    return op, jitted, got


@pytest.mark.parametrize("policy_name", POLICIES)
def test_protect_linear_matches_jax(monkeypatch, policy_name):
    cases = [(False, True), (True, False)]
    if policy_name == "cl":             # per-row weight flips and the DPPU
        cases.append((True, True))
    for i, (per_row, wf) in enumerate(cases):
        op, jitted, got = _case(monkeypatch, policy_name, per_row, wf,
                                jit=policy_name == "cl" and i < 2)
        msg = f"{policy_name} per_row={per_row} weight_faults={wf}"
        for b in ("reference", "fused"):
            for name, want, have in zip(("y", "yq", "t"), op, got[b]):
                _assert_bitwise(want, have, f"{b} {name} vs op-by-op {msg}")
        if jitted is not None:
            assert ((jitted == 0) == (op[0] == 0)).all(), msg
            ulp = _ulp_distance(jitted, got["reference"][0]).max()
            assert ulp <= MAX_ULP, (msg, ulp)

