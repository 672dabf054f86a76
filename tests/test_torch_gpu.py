"""The port's CUDA kernels against their plain versions, on the card:
fused_decode, and the DLA kernels qmatmul, protected_mm and fault_inject;
the serving paths on the card against the CPU; and the decode steps
replayed as CUDA graphs (Engine(loop="scan"), the Scheduler's chunk)
against the same steps run eagerly.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  The file
imports neither jax nor the JAX package, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports jax.)
"""
import numpy as np
import pytest
import torch

from repro_torch import ft
from repro_torch.core import prng
from repro_torch.core import quantization as Q
from repro_torch.kernels.fault_inject import kernel as fi_kernel
from repro_torch.kernels.fault_inject.ref import inject_ref
from repro_torch.kernels.fused_decode import kernel
from repro_torch.kernels.fused_decode.ref import fused_ref
from repro_torch.kernels.protected_mm import kernel as pm_kernel
from repro_torch.kernels.protected_mm.ref import protected_mm_ref
from repro_torch.kernels.qmatmul import kernel as qm_kernel
from repro_torch.kernels.qmatmul.ref import qmatmul_ref

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

POLICIES = ("base", "crt1", "crt2", "crt3", "arch", "alg", "cl")
# shapes that cross the GEMM core's boundaries (as chip_smoke.py's): M at
# and past the 16-row decode tile, K under one 64-step, ragged, and split
# with a ragged last chunk, N ragged against the tiles and 16-byte rows
EDGE_SHAPES = tuple((m, k, n) for m in (1, 16, 17) for k in (31, 200, 2561)
                    for n in (130, 648))
MODES = ([(pr, d, False) for pr in (False, True)
          for d in ("none", "reuse", "w", "wcl")]
         + [(pr, d, True) for pr in (False, True) for d in ("none", "w", "wcl")])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel runs only on the "
                    "card")
    return torch.device("cuda")


def _operands(m, k, n, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def words(*s):
        w = torch.randint(0, 256, s, generator=g, device=dev,
                          dtype=torch.int32)
        return torch.where(torch.rand(s, generator=g, device=dev) < 0.2, w,
                           torch.zeros_like(w))

    def i8(*s):
        return torch.randint(-128, 128, s, generator=g, device=dev,
                             dtype=torch.int8)
    return dict(xq=i8(m, k), wq=i8(k, n), wq_clean=i8(k, n),
                oflips=words(m, n), dflips=words(m, n),
                wflips=words(m, k, n),
                imp=(torch.rand(n, generator=g, device=dev) < 0.4)
                .to(torch.int32))


def _edges(ops):
    """Sign-correlated rows and columns that drive the epilogue's clamps:
    rows of 127 and of -128 against columns of 127 and of -128 reach
    |acc| = 127*128*K > 2**23 once K > 516, so the 24-bit saturation fires
    at both ends and those rows' t reaches its upper clamp of 16; a zero
    row (t = 0) and a row of -1/0/1 (small t) sit below any q_scale > 6.
    (Saturating at 24 bits looks the same as not saturating, as t <= 16
    puts the 8-bit window's own clamp below 2**23; a narrower saturation
    would show.)"""
    xq, wq = ops["xq"], ops["wq"]
    for r, v in zip(range(xq.shape[0]), (127, -128, 0)):
        xq[r] = v
    if xq.shape[0] > 3:
        xq[3] = xq[3] % 3 - 1
    wq[:, 0], wq[:, 1], wq[:, 2] = 127, -128, 0
    return ops


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element (1 byte of
    int8, 1 word of int32) off a 16-byte boundary (the kernels' 16-byte
    copies do not apply to it)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out = out.view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == t.element_size()
    return out


def _check_kernel(ops, q, m, per_row, dppu_src, perrow_wf):
    kw = {}
    if dppu_src != "none":
        kw.update(dflips=ops["dflips"], imp=ops["imp"])
    if dppu_src == "wcl":
        kw["wq_clean"] = ops["wq_clean"]
    if perrow_wf:
        kw["wflips"] = ops["wflips"]
    q_scale = torch.tensor([q], dtype=torch.int32, device=ops["xq"].device)
    args = (ops["xq"], ops["wq"], ops["oflips"])
    before = kernel.fused_decode.launches
    y, t = kernel.fused_decode(*args, q_scale, per_row=per_row,
                               dppu_src=dppu_src, perrow_wf=perrow_wf, **kw)
    torch.cuda.synchronize()
    assert kernel.fused_decode.launches == before + 1
    yr, tr = fused_ref(*args, q_scale.reshape(()), per_row=per_row, **kw)
    assert torch.equal(y, yr.to(torch.int8))
    assert torch.equal(t, torch.broadcast_to(tr.reshape(-1, 1), (m, 1)))
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("per_row,dppu_src,perrow_wf", MODES)
@pytest.mark.parametrize("mkn", ((4, 2560, 640), (37, 300, 130),
                                 (70, 1000, 200)))
def test_kernel_matches_plain(cuda, mkn, per_row, dppu_src, perrow_wf):
    m, k, n = mkn
    _check_kernel(_operands(m, k, n, cuda, seed=m), 4, m, per_row, dppu_src,
                  perrow_wf)


# (M, K, N) of the encoder-decoder and vision families' projections at their
# published widths (B = 4): seamless-m4t-medium's (1024, 1024), (1024,
# 4096) and (4096, 1024) at decode and at a 64-token prefill, its xk/xv at
# a 96-frame encoder input; paligemma-3b's at decode and at a prefill of
# 256 patches + 64 tokens, K = 16384 (its MLP's wo) the deepest K served
ENC_VISION_SHAPES = (
    tuple((m, k, n) for k, n in ((1024, 1024), (1024, 4096), (4096, 1024))
          for m in (4, 256)) + ((384, 1024, 1024),)
    + tuple((m, k, n) for k, n in ((2048, 2048), (2048, 256), (2048, 16384),
                                   (16384, 2048)) for m in (4, 1280)))


@pytest.mark.gpu
@pytest.mark.parametrize("per_row", (False, True))
@pytest.mark.parametrize("mkn", ENC_VISION_SHAPES)
def test_kernel_matches_plain_at_the_enc_dec_and_vision_shapes(cuda, mkn,
                                                               per_row):
    """No DPPU, global and per-row t: random operands at q_scale 4, then
    the epilogue's clamps (``_edges``) at q_scale 0, 12 and 20."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(k + n)
    ops = dict(xq=torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                                dtype=torch.int8),
               wq=torch.randint(-128, 128, (k, n), generator=g, device=cuda,
                                dtype=torch.int8),
               oflips=torch.randint(0, 256, (m, n), generator=g, device=cuda,
                                    dtype=torch.int32))
    _check_kernel(ops, 4, m, per_row, "none", False)
    ops = _edges(ops)
    for q in (0, 12, 20):
        _check_kernel(ops, q, m, per_row, "none", False)


@pytest.mark.gpu
@pytest.mark.parametrize("per_row,dppu_src,perrow_wf", MODES)
@pytest.mark.parametrize("mkn", ((4, 2560, 640), (37, 1000, 130)))
def test_kernel_matches_plain_at_the_clamps(cuda, mkn, per_row, dppu_src,
                                            perrow_wf):
    """Saturation, t's upper clamp and q_scale's lower clamp all bind; a
    q_scale above 16 checks the clamp order (t = min(max(t, q), 16))."""
    m, k, n = mkn
    ops = _edges(_operands(m, k, n, cuda, seed=m + 1))
    acc = Q.int_matmul(ops["xq"].to(torch.int32), ops["wq"].to(torch.int32))
    assert int(acc.max()) >= 1 << 23 and int(acc.min()) < -(1 << 23)
    for q in (0, 12, 20):
        t = _check_kernel(ops, q, m, per_row, dppu_src, perrow_wf)
        if q == 20:
            assert bool((t == 16).all())
        elif per_row and not perrow_wf:
            assert int(t[0]) == int(t[1]) == 16
            assert int(t[2]) == q


@pytest.mark.gpu
@pytest.mark.parametrize("per_row,dppu_src", [(pr, d) for pr in (False, True)
                                              for d in ("none", "reuse", "w",
                                                        "wcl")])
@pytest.mark.parametrize("mkn", EDGE_SHAPES)
def test_kernel_matches_plain_at_the_core_boundaries(cuda, mkn, per_row,
                                                     dppu_src):
    """Ragged tiles, K chunks and 16-byte rows, on random operands (q_scale
    4) and on clamp-driving ones (q_scale 0, 12, 20)."""
    m, k, n = mkn
    _check_kernel(_operands(m, k, n, cuda, seed=m + k + n), 4, m, per_row,
                  dppu_src, False)
    ops = _edges(_operands(m, k, n, cuda, seed=m + k + n + 1))
    for q in (0, 12, 20):
        _check_kernel(ops, q, m, per_row, dppu_src, False)


@pytest.mark.gpu
@pytest.mark.parametrize("mkn,per_row,dppu_src,perrow_wf", [
    (mkn, *mode) for mkn in ((4, 2560, 640), (17, 2561, 648))
    for mode in MODES if mkn[0] == 4 or not mode[2]])
def test_kernel_matches_plain_on_misaligned_operands(cuda, mkn, per_row,
                                                     dppu_src, perrow_wf):
    """xq and wq (and wq_clean) contiguous but 1 byte off 16-byte
    alignment: the byte-load path of the same kernel (per-row weight flips
    at M = 4 only, for their (M, K, N) flip words' memory)."""
    m, k, n = mkn
    ops = _operands(m, k, n, cuda, seed=n)
    for name in ("xq", "wq", "wq_clean"):
        ops[name] = _misaligned(ops[name])
    _check_kernel(ops, 4, m, per_row, dppu_src, perrow_wf)
    _check_kernel(_edges(ops), 12, m, per_row, dppu_src, perrow_wf)


@pytest.mark.gpu
def test_kernel_rejects_bad_operands(cuda):
    ops = _operands(4, 64, 32, cuda, seed=0)
    q = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kernel.fused_decode(ops["xq"].to(torch.int32), ops["wq"],
                            ops["oflips"], q)
    with pytest.raises(ValueError):
        kernel.fused_decode(ops["xq"], ops["wq"].t(), ops["oflips"], q)
    with pytest.raises(ValueError):
        kernel.fused_decode(ops["xq"], ops["wq"].cpu(), ops["oflips"], q)


@pytest.mark.gpu
@pytest.mark.parametrize("policy_name", POLICIES)
def test_fused_backend_equals_reference_and_cpu(cuda, policy_name):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 72)).astype(np.float32))
    imp = torch.from_numpy(rng.random(72) < 0.3)
    pol = ft.get_policy(policy_name, ber=1e-2, weight_faults=True)
    for key in (prng.PRNGKey(3), prng.split(prng.PRNGKey(4), 6)):
        want = ft.protect_linear(key, x, w, pol, imp)            # CPU
        for backend in ("reference", "fused"):
            got = ft.protect_linear(key.to(cuda), x.to(cuda), w.to(cuda),
                                    pol, imp.to(cuda), backend=backend)
            assert torch.equal(got.cpu(), want), backend


# ------------------------------------------- qmatmul, protected_mm, inject --
DLA_SHAPES = ((4, 2560, 640), (37, 1000, 130), (5, 200, 130)) + EDGE_SHAPES
# (M, K, N) of the main path's projections: prefill (M = 4 x 64) and decode
# (M = 4) of each of danube's (K, N)
MAIN_SHAPES = tuple((m, k, n) for k, n in ((2560, 2560), (2560, 640),
                                           (2560, 6912), (6912, 2560))
                    for m in (256, 4))
# (t, ber, ib, nb): t at 0, 1 and 16; BER 0, 1e-2 and 1.0; ib and nb at 0
# and 8 and between
PM_EDGES = ((0, 0.0, 2, 1), (1, 1e-2, 0, 0), (16, 1e-2, 8, 8),
            (3, 1.0, 8, 0), (16, 1.0, 0, 8), (5, 1e-2, 2, 1))


def _dla_operands(m, k, n, dev, seed, edges=False):
    """int8 operands (with edges: rows and columns that saturate the 24-bit
    accumulator at both ends), uint32 planes as int32 bit patterns with low
    words mixed in (BER 1e-2 flips) and all-ones words in row 0 (which BER
    1.0 leaves), and a mixed important mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xq = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    if edges:
        for r, v in zip(range(m), (127, -128, 0)):
            xq[r] = v
        wq[:, 0], wq[:, 1] = 127, -128

    def planes():
        w = torch.randint(0, 1 << 32, (8, m, n), generator=g, device=dev,
                          dtype=torch.int64)
        low = torch.rand((8, m, n), generator=g, device=dev) < 0.05
        w = torch.where(low, w >> 8, w)
        w[:, 0] = (1 << 32) - 1
        return prng.as_int32_bits(w)
    imp = (torch.rand(n, generator=g, device=dev) < 0.4).to(torch.int32)
    return xq, wq, planes(), planes(), imp


@pytest.mark.gpu
@pytest.mark.parametrize("edges", (False, True))
@pytest.mark.parametrize("mkn", DLA_SHAPES)
def test_qmatmul_matches_plain(cuda, mkn, edges):
    xq, wq, *_ = _dla_operands(*mkn, cuda, seed=mkn[0], edges=edges)
    if edges and mkn[1] > 516:          # 127 * 127 * K > 2**23
        acc = Q.int_matmul(xq.to(torch.int32), wq.to(torch.int32))
        assert int(acc.max()) >= 1 << 23 and int(acc.min()) < -(1 << 23)
    for t in (0, 1, 16):
        before = qm_kernel.qmatmul.launches
        y = qm_kernel.qmatmul(xq, wq, t)
        torch.cuda.synchronize()
        assert qm_kernel.qmatmul.launches == before + 1
        assert torch.equal(y, qmatmul_ref(xq, wq, t)), t


@pytest.mark.gpu
@pytest.mark.parametrize("edges", (False, True))
@pytest.mark.parametrize("mkn", ((4, 2560, 640), (17, 2561, 648)))
def test_qmatmul_matches_plain_on_misaligned_operands(cuda, mkn, edges):
    """xq and wq 1 byte off 16-byte alignment: the byte-load path of the
    split-K core."""
    xq, wq, *_ = _dla_operands(*mkn, cuda, seed=mkn[2], edges=edges)
    xq, wq = _misaligned(xq), _misaligned(wq)
    for t in (0, 1, 16):
        y = qm_kernel.qmatmul(xq, wq, t)
        torch.cuda.synchronize()
        assert torch.equal(y, qmatmul_ref(xq, wq, t)), t


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", MAIN_SHAPES)
def test_qmatmul_matches_plain_at_the_main_shapes(cuda, mkn):
    """Saturating operands (both ends of the 24-bit accumulator) at the
    main path's shapes, whose plans split K into 1 to 8 chunks."""
    xq, wq, *_ = _dla_operands(*mkn, cuda, seed=mkn[1] + mkn[2], edges=True)
    acc = Q.int_matmul(xq.to(torch.int32), wq.to(torch.int32))
    assert int(acc.max()) >= 1 << 23 and int(acc.min()) < -(1 << 23)
    for t in (0, 1, 16):
        before = qm_kernel.qmatmul.launches
        y = qm_kernel.qmatmul(xq, wq, t)
        torch.cuda.synchronize()
        assert qm_kernel.qmatmul.launches == before + 1
        assert torch.equal(y, qmatmul_ref(xq, wq, t)), t


@pytest.mark.gpu
@pytest.mark.parametrize("edges", (False, True))
@pytest.mark.parametrize("mkn", DLA_SHAPES)
def test_protected_mm_matches_plain(cuda, mkn, edges):
    xq, wq, ro, ri, imp = _dla_operands(*mkn, cuda, seed=mkn[0] + 1,
                                        edges=edges)
    for t, ber, ib, nb in PM_EDGES:
        kw = dict(t=t, ber=ber, ib=ib, nb=nb)
        before = pm_kernel.protected_mm.launches
        y = pm_kernel.protected_mm(xq, wq, ro, ri, imp, **kw)
        torch.cuda.synchronize()
        assert pm_kernel.protected_mm.launches == before + 1
        assert torch.equal(y, protected_mm_ref(xq, wq, ro, ri, imp, **kw)), kw


@pytest.mark.gpu
@pytest.mark.parametrize("edges", (False, True))
@pytest.mark.parametrize("mkn", ((4, 2560, 640), (17, 2561, 648)))
def test_protected_mm_matches_plain_on_misaligned_operands(cuda, mkn, edges):
    xq, wq, ro, ri, imp = _dla_operands(*mkn, cuda, seed=mkn[2],
                                        edges=edges)
    xq, wq = _misaligned(xq), _misaligned(wq)
    for t, ber, ib, nb in PM_EDGES:
        kw = dict(t=t, ber=ber, ib=ib, nb=nb)
        y = pm_kernel.protected_mm(xq, wq, ro, ri, imp, **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, protected_mm_ref(xq, wq, ro, ri, imp, **kw)), kw


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", DLA_SHAPES)
def test_fault_inject_matches_plain(cuda, mkn):
    m, _, n = mkn
    _, _, rnd, _, _ = _dla_operands(*mkn, cuda, seed=mkn[0] + 2)
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(-128, 128, (m, n), generator=g, device=cuda,
                      dtype=torch.int32)
    prot = (torch.arange(n, device=cuda) % 9).to(torch.int32)
    for ber in (0.0, 1e-2, 1.0):
        before = fi_kernel.fault_inject.launches
        y = fi_kernel.fault_inject(x, rnd, prot, ber)
        torch.cuda.synchronize()
        assert fi_kernel.fault_inject.launches == before + 1
        assert torch.equal(y, inject_ref(x, rnd, prot, ber)), ber
        if ber == 0.0:
            assert torch.equal(y, x)


@pytest.mark.gpu
@pytest.mark.parametrize("misaligned", (False, True))
@pytest.mark.parametrize("mn", ((256, 6912), (256, 640), (4, 2560),
                                (17, 130)))
def test_fault_inject_matches_plain_at_every_protect(cuda, mn, misaligned):
    """protect -1, 0, 3, 8 and 9 mixed within each group of 4 columns (a
    negative count exposes every bit, 8 or more none), on contiguous
    operands (the 16-byte path where N allows it) and with x, the planes
    and protect 1 word off 16-byte alignment (the word-by-word path)."""
    m, n = mn
    _, _, rnd, _, _ = _dla_operands(m, 1, n, cuda, seed=m + n)
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    x = torch.randint(-128, 128, (m, n), generator=g, device=cuda,
                      dtype=torch.int32)
    prot = torch.tensor((-1, 0, 3, 8, 9), dtype=torch.int32,
                        device=cuda)[torch.arange(n, device=cuda) % 5]
    if misaligned:
        x, rnd, prot = _misaligned(x), _misaligned(rnd), _misaligned(prot)
    for ber in (0.0, 1e-2, 1.0):
        before = fi_kernel.fault_inject.launches
        y = fi_kernel.fault_inject(x, rnd, prot, ber)
        torch.cuda.synchronize()
        assert fi_kernel.fault_inject.launches == before + 1
        assert torch.equal(y, inject_ref(x, rnd, prot, ber)), ber
        if ber == 1.0:      # prot -1 and 0 flip every bit but in row 0
            assert torch.equal((y[1:, :2] ^ x[1:, :2]) & 0xFF,
                               torch.full_like(x[1:, :2], 0xFF))


@pytest.mark.gpu
def test_dla_kernels_reject_bad_operands(cuda):
    xq, wq, ro, ri, imp = _dla_operands(4, 64, 32, cuda, seed=0)
    x32 = xq.to(torch.int32)[:, :32].contiguous()
    pm = dict(t=3, ber=1e-2, ib=2, nb=1)
    with pytest.raises(TypeError):
        qm_kernel.qmatmul(xq.to(torch.int32), wq, 3)
    with pytest.raises(ValueError):
        qm_kernel.qmatmul(xq, wq.cpu(), 3)
    with pytest.raises(ValueError):
        qm_kernel.qmatmul(xq, wq.t(), 3)
    with pytest.raises(ValueError):
        qm_kernel.qmatmul(xq, wq, 31)
    with pytest.raises(TypeError):
        pm_kernel.protected_mm(xq, wq, ro.to(torch.int64), ri, imp, **pm)
    with pytest.raises(ValueError):
        pm_kernel.protected_mm(xq, wq, ro[:, :2], ri, imp, **pm)
    with pytest.raises(ValueError):
        pm_kernel.protected_mm(xq, wq, ro, ri, imp.cpu(), **pm)
    with pytest.raises(TypeError):
        fi_kernel.fault_inject(x32.to(torch.int8), ro, imp, 1e-2)
    with pytest.raises(ValueError):
        fi_kernel.fault_inject(x32, ro[:, :, :16], imp, 1e-2)
    with pytest.raises(ValueError):
        fi_kernel.fault_inject(x32, ro.cpu(), imp, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("policy_name", POLICIES)
def test_pallas_backend_equals_cpu(cuda, policy_name):
    """t given and calibrated, layer_protected both ways, an important
    mask; the planes are drawn over the padded (128, 128) output."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((6, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 72)).astype(np.float32))
    imp = torch.from_numpy(rng.random(72) < 0.3)
    pol = ft.get_policy(policy_name, ber=1e-2)
    key = prng.PRNGKey(8)
    for t in (5, None):
        for lp in (True, False):
            want = ft.protect_linear(key, x, w, pol, imp, backend="pallas",
                                     t=t, layer_protected=lp)
            got = ft.protect_linear(key.to(cuda), x.to(cuda), w.to(cuda),
                                    pol, imp.to(cuda), backend="pallas", t=t,
                                    layer_protected=lp)
            assert torch.equal(got.cpu(), want), (t, lp)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _reduced_scheduler_run(dev, params, backend, kv, temperature=0.0,
                           loop="scan"):
    """Reduced danube (float32) through the Scheduler: 5 requests on 2
    slots, crt1 at BER 1e-2 with per-row weight faults (none at a
    temperature).  Returns ({rid: (tokens, finish_reason)}, SchedStats)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    model = build(cfg, RunConfig(param_dtype="float32",
                                 compute_dtype="float32"))
    rng = np.random.default_rng(30)
    reqs = [Request(rid=i, tokens=[int(t) for t in rng.integers(
                0, cfg.vocab, 3 + 3 * (i % 3))], max_new_tokens=4 + i % 3)
            for i in range(5)]
    pol = (None if temperature else
           ft.get_policy("crt1", ber=1e-2, weight_faults=True))
    sched = Scheduler(model, _to(params, dev), SchedulerConfig(
        max_batch=2, buckets=(8, 16), max_new_tokens=6, decode_chunk=3,
        kv=kv, block_size=4, temperature=temperature), policy=pol,
        ft_backend=backend, loop=loop)
    out = sched.run(reqs)
    return ({rid: (r.generated, r.finish_reason) for rid, r in out.items()},
            sched.stats)


def _reduced_params():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build
    model = build(get_config("h2o-danube-1.8b", reduced=True),
                  RunConfig(param_dtype="float32", compute_dtype="float32"))
    return model.init(torch.Generator().manual_seed(11), device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("backend,kv", (("fused", "paged"),
                                        ("reference", "dense"),
                                        ("fused", "dense")))
def test_scheduler_backends_and_layouts_agree_on_the_card(cuda, backend, kv):
    """Under per-row weight faults on the card, fused (fused_decode per row
    at decode, global at prefill) = reference, and dense = paged, per
    request, on the same float operands."""
    params = _reduced_params()
    want, _ = _reduced_scheduler_run(cuda, params, "reference", "paged")
    assert _reduced_scheduler_run(cuda, params, backend, kv)[0] == want


@pytest.mark.gpu
def test_scheduler_projections_equal_cpu(cuda, monkeypatch):
    """Every protected projection of the fused Scheduler run on the card
    (7 per layer, per prefill call and per decode step) equals the CPU's
    reference backend on the same operands, bitwise: the keys, flip words
    and integer datapath of both modes.  (Whole-run tokens are held across
    devices only clean: the card's and the CPU's float ops, rms_norm first,
    differ in the last place, and a quantization rounding that lands on .5
    turns that into a different int8 operand: chip_smoke.py's split line
    finds that projection.)"""
    import repro_torch.ft as ftmod
    real = ftmod.protect_linear
    n = 0

    def checked(key, x, w, policy, important=None, **kw):
        nonlocal n
        y = real(key, x, w, policy, important, **kw)
        want = real(key.cpu(), x.cpu(), w.cpu(), policy,
                    None if important is None else important.cpu(),
                    **dict(kw, backend="reference"))
        assert torch.equal(y.cpu(), want), (n, tuple(x.shape), key.shape)
        n += 1
        return y
    monkeypatch.setattr(ftmod, "protect_linear", checked)
    # the eager loop, so that every step calls protect_linear (a graph
    # replay calls no Python)
    _, stats = _reduced_scheduler_run(cuda, _reduced_params(), "fused",
                                      "paged", loop="python")
    assert n == 7 * 2 * (stats.prefill_calls + 3 * stats.chunk_calls)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ("paged", "dense"))
@pytest.mark.parametrize("temperature", (0.0, 0.8))
def test_clean_scheduler_equals_cpu(cuda, kv, temperature):
    """Clean, the card's tokens are the CPU's at temperature 0 and 0.8 (the
    per-row sampling keys; logits agree to float rounding)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    model = build(cfg, RunConfig(param_dtype="float32",
                                 compute_dtype="float32"))
    params = _reduced_params()
    rng = np.random.default_rng(32)
    spec = [(i, [int(t) for t in rng.integers(0, cfg.vocab, 3 + 3 * (i % 3))],
             4 + i % 3) for i in range(5)]

    def run(dev):
        sched = Scheduler(model, _to(params, dev), SchedulerConfig(
            max_batch=2, buckets=(8, 16), max_new_tokens=6, decode_chunk=3,
            kv=kv, block_size=4, temperature=temperature))
        out = sched.run([Request(rid=r, tokens=t, max_new_tokens=k)
                         for r, t, k in spec])
        return {rid: r.generated for rid, r in out.items()}
    assert run(cuda) == run("cpu")


@pytest.mark.gpu
def test_categorical_equals_cpu(cuda):
    """One key over (4, 32000) logits, and one key per row."""
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 32000)).astype(np.float32) * 3)
    for key in (prng.PRNGKey(5), prng.split(prng.PRNGKey(6), 4)):
        want = prng.categorical(key, logits)
        got = prng.categorical(key.to(cuda), logits.to(cuda))
        assert torch.equal(got.cpu(), want)


# ------------------------------------------------------ CUDA-graph decode --
def _reduced_engine_pair(cuda, backend):
    """Reduced danube (float32) on the card, and an Engine factory for
    ``loop``: crt3 at BER 3e-3 on the pallas backend (ft_t 6), cl with
    weight faults on the fused one."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    model = build(cfg, RunConfig(param_dtype="float32",
                                 compute_dtype="float32"))
    params = _to(_reduced_params(), cuda)
    pallas = backend == "pallas"
    pol = ft.get_policy("crt3" if pallas else "cl", ber=3e-3,
                        weight_faults=not pallas)

    def engine(loop):
        return Engine(model, params, cfg=ServeConfig(max_new_tokens=4),
                      policy=pol, ft_backend=backend,
                      ft_t=6 if pallas else None, loop=loop)
    return cfg, engine


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ("fused", "pallas"))
def test_scan_graph_equals_python_loop_on_the_card(cuda, backend):
    """Engine(loop="scan") on the card: its first generation runs step 0
    as the warm-up, captures the step and replays it for steps 1-3; the
    next ones only replay, also at another prompt length.  Each equals the
    python loop's tokens on the card, bitwise."""
    cfg, engine = _reduced_engine_pair(cuda, backend)
    scan, python = engine("scan"), engine("python")
    g = torch.Generator().manual_seed(40)
    for i, S in enumerate((20, 20, 6)):
        batch = {"tokens": torch.randint(0, cfg.vocab, (3, S),
                                         generator=g).to(cuda)}
        got = scan.generate(batch, seed=i)
        assert scan.stats.roundtrips == 2
        assert torch.equal(got, python.generate(batch, seed=i)), i
    step = scan._scan_step
    assert step.graph.graph is not None and step.graph.replays == 3 + 4 + 4
    assert step.graph.capture_s > 0
    assert step.graph.captured_calls == 7 * cfg.n_layers   # projections


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", (0.0, 0.8))
def test_graph_scheduler_equals_eager_on_the_card(cuda, temperature):
    """The Scheduler's chunk replayed as a CUDA graph equals the same step
    run eagerly (loop="python") on the card, per request: under crt1 with
    per-row weight faults, and clean at a temperature; a second run on the
    same Scheduler (its caches zeroed, its graph kept) equals the first."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    model = build(cfg, RunConfig(param_dtype="float32",
                                 compute_dtype="float32"))
    params = _to(_reduced_params(), cuda)
    rng = np.random.default_rng(33)
    spec = [(i, [int(t) for t in rng.integers(0, cfg.vocab, 3 + 3 * (i % 3))],
             4 + i % 3) for i in range(5)]
    pol = (None if temperature else
           ft.get_policy("crt1", ber=1e-2, weight_faults=True))

    def scheduler(loop):
        return Scheduler(model, params, SchedulerConfig(
            max_batch=2, buckets=(8, 16), max_new_tokens=6, decode_chunk=3,
            block_size=4, temperature=temperature), policy=pol,
            ft_backend="fused", loop=loop)

    def run(sched):
        out = sched.run([Request(rid=r, tokens=t, max_new_tokens=k)
                         for r, t, k in spec])
        return {rid: r.generated for rid, r in out.items()}
    graphed = scheduler("scan")
    want = run(scheduler("python"))
    assert run(graphed) == want
    assert run(graphed) == want
    assert graphed._step.graph.replays == 2 * 3 * graphed.stats.chunk_calls - 1
    assert graphed._step.graph.captured_calls == (7 * cfg.n_layers if pol
                                                  else 0)


@pytest.mark.gpu
def test_capture_with_a_host_sync_raises(cuda):
    """A step that reads a device value on the host cannot be captured:
    StepGraph raises, and does not fall back to running it eagerly.  (In a
    process of its own: a failed capture may leave the process's current
    stream behind.)"""
    import os
    import subprocess
    import sys
    code = (
        "import torch\n"
        "from repro_torch.serve.graphs import StepGraph\n"
        "x = torch.zeros((), device='cuda')\n"
        "def step():\n"
        "    x.add_(1)\n"
        "    int(x)\n"
        "g = StepGraph(step, 'cuda')\n"
        "try:\n"
        "    g()\n"
        "except RuntimeError as e:\n"
        "    print('raised', g.graph is None, repr(str(e)[:200]))\n"
        "else:\n"
        "    print('ran', float(x))\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.stdout.startswith("raised True"), (out.stdout, out.stderr)


# ------------------------------------------------------------- training --
@pytest.mark.gpu
@pytest.mark.parametrize("policy_name", ("cl", "crt3", "arch"))
def test_ste_forward_equals_cpu(cuda, policy_name):
    """protect_linear_ste on the card (fused backend): its forward equals
    the CPU's plain version on equal operands, bitwise, and its gradients
    are the clean matmul's."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((64, 200)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((200, 130)).astype(np.float32))
    pol = ft.get_policy(policy_name, ber=1e-2, weight_faults=False)
    key = prng.PRNGKey(21)
    want = ft.protect_linear(key, x, w, pol, backend="reference")
    xs, ws = (t.to(cuda).requires_grad_(True) for t in (x, w))
    y = ft.protect_linear_ste(key.to(cuda), xs, ws, pol, backend="fused")
    assert torch.equal(y.detach().cpu(), want)
    g = torch.ones_like(y)
    gx, gw = torch.autograd.grad(y, (xs, ws), g)
    assert torch.equal(gx, g @ ws.detach().T)
    assert torch.equal(gw, xs.detach().T @ g)


@pytest.mark.gpu
def test_fat_train_step_launches_equal_plain(cuda, monkeypatch):
    """One FAT train step of the reduced model on the card (crt1 at BER
    1e-2, fused backend, every layer recomputed in the backward pass):
    every fused_decode launch equals fused_ref on its operands, bitwise,
    7 sites x 2 layers x 2 (forward and recompute)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.fused_decode import ops as fops
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    model = build(get_config("h2o-danube-1.8b", reduced=True),
                  RunConfig(param_dtype="float32", compute_dtype="float32"))
    params = _to(_reduced_params(), cuda)
    state = {"params": params, **init_opt_state(params, AdamWConfig())}
    real, n = fops.fused_decode, 0

    def checked(xq, wq, oflips, q_scale, **kw):
        nonlocal n
        y, t = real(xq, wq, oflips, q_scale, **kw)
        imp = kw.get("imp")
        yr, tr = fused_ref(xq, wq, oflips, q_scale.reshape(()),
                           per_row=kw["per_row"], wflips=kw.get("wflips"),
                           wq_clean=kw.get("wq_clean"),
                           dflips=kw.get("dflips"),
                           imp=None if imp is None else imp.reshape(-1))
        assert torch.equal(y.to(torch.int32), yr), n
        assert torch.equal(t.reshape(-1), torch.broadcast_to(
            tr.reshape(-1, 1), t.shape).reshape(-1)), n
        n += 1
        return y, t
    monkeypatch.setattr(fops, "fused_decode", checked)
    step = make_train_step(model, AdamWConfig(), policy="crt1", ft_ber=1e-2,
                           ft_backend="fused")
    toks = torch.randint(0, model.cfg.vocab, (4, 32),
                         generator=torch.Generator().manual_seed(2))
    new, metrics = step(state, {"tokens": toks.to(cuda)})
    assert n == 7 * 2 * 2
    assert torch.isfinite(metrics["loss"]) and int(new["step"]) == 1


@pytest.mark.gpu
def test_checkpoint_bf16_round_trip(cuda, tmp_path):
    """A train state with bf16 parameters and float32 moments on the card:
    saved and restored to the card, every leaf bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import init_state
    from repro_torch.tree import items
    model = build(get_config("h2o-danube-1.8b", reduced=True), RunConfig())
    state = init_state(model, torch.Generator(device=cuda).manual_seed(3),
                       AdamWConfig(), cuda)
    state["m"]["embed"].normal_()
    state["step"].fill_(9)
    ckpt.save(str(tmp_path), state, 9, data_state={"step": 9})
    like = init_state(model, torch.Generator(), AdamWConfig(), "meta")
    got, step, ds = ckpt.restore(str(tmp_path), like, device=cuda)
    assert step == 9 and ds == {"step": 9}
    assert got["params"]["embed"].dtype == torch.bfloat16
    for (name, a), (_, b) in zip(items(state), items(got)):
        assert b.device.type == "cuda" and a.dtype == b.dtype, name
        assert torch.equal(a, b), name
