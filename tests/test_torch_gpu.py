"""The port's CUDA kernel against its plain version, on the card.

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
from repro_torch.kernels.fused_decode import kernel
from repro_torch.kernels.fused_decode.ref import fused_ref

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

POLICIES = ("base", "crt1", "crt2", "crt3", "arch", "alg", "cl")
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
    xq[0], xq[1], xq[2] = 127, -128, 0
    xq[3] = xq[3] % 3 - 1
    wq[:, 0], wq[:, 1], wq[:, 2] = 127, -128, 0
    return ops


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
