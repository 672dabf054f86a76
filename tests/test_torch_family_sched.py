"""The families' Schedulers under faults: the port's Scheduler against the
jitted JAX Scheduler under crt1 at BER 1e-2 (no weight faults, as
tests/test_torch_scheduler.py's danube run), paged, for mamba2-2.7b
(exact-length prefill), paligemma-3b (8 patch rows per request, bucketed)
and qwen3-moe-235b-a22b (bucketed), at their reduced sizes in float32:
every request's tokens equal, on the port's reference and fused backends.

seamless-m4t-medium and recurrentgemma-9b are left out for their cost: the
reference Scheduler's executables under crt1 compile in ~170 s and ~420 s
on one CPU, against 20-47 s for these three.  Their clean Schedulers are
held in tests/test_torch_encdec_vision.py and
tests/test_torch_families.py.
"""
import functools

import numpy as np
import pytest
import torch

from repro import ft as jft
from repro.serve import scheduler as jsched
from repro_torch import ft as tft
from repro_torch.serve import scheduler as tsched
from test_torch_families import _models, _tokens

torch.set_num_threads(1)

BER = 1e-2
ARCHS = ("mamba2-2.7b", "paligemma-3b", "qwen3-moe-235b-a22b")
SCHED = dict(max_batch=2, max_new_tokens=5, decode_chunk=2, kv="paged")
# recurrent layers prefill at exact length; the others take a bucket
EXACT = dict(buckets=None, max_prompt=8)
BUCKETED = dict(buckets=(8,))


def _sched_cfg(mod, cfg):
    return mod.SchedulerConfig(**SCHED, **(EXACT if cfg.ssm else BUCKETED))


def _requests(mod, cfg, n=3):
    """Prompts of 4, 6 and 5 tokens (mamba2's reduced state has 8 heads and
    a 3-row conv history, lengths the reference's prefill would pad:
    tests/test_torch_families.py), paligemma's with 8 patch rows."""
    rng = np.random.default_rng(70)
    out = []
    for i in range(n):
        toks = [int(t) for t in rng.integers(0, cfg.vocab, (4, 6, 5)[i % 3])]
        extras = ({"patch_embeds": rng.standard_normal(
            (cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}
            if cfg.frontend == "vision" else {})
        out.append(mod.Request(rid=i, tokens=toks, max_new_tokens=5,
                               extras=extras))
    return out


@functools.cache
def _jax_tokens(arch):
    jm, jp, _, _ = _models(arch)
    pol = jft.get_policy("crt1", ber=BER, weight_faults=False)
    sched = jsched.Scheduler(jm, jp, _sched_cfg(jsched, jm.cfg), policy=pol)
    return _tokens(sched.run(_requests(jsched, jm.cfg)))


@pytest.mark.parametrize("backend", ("reference", "fused"))
@pytest.mark.parametrize("arch", ARCHS)
def test_faulty_scheduler_equals_reference(arch, backend):
    _, _, tm, tp = _models(arch)
    pol = tft.get_policy("crt1", ber=BER, weight_faults=False)
    sched = tsched.Scheduler(tm, tp, _sched_cfg(tsched, tm.cfg), policy=pol,
                             ft_backend=backend)
    got = _tokens(sched.run(_requests(tsched, tm.cfg)))
    assert got == _jax_tokens(arch)
    assert all(len(g) == 5 for g in got.values())


@pytest.mark.parametrize("arch", ("mamba2-2.7b", "qwen3-moe-235b-a22b"))
def test_faults_move_tokens(arch):
    """The crt1 run's tokens differ from the same workload served clean, so
    the check above can fail.  (paligemma's reduced model emits the same
    tokens with and without these faults; its faulty projections are held
    bit for bit in tests/test_torch_encdec_vision.py.)"""
    _, _, tm, tp = _models(arch)
    clean = tsched.Scheduler(tm, tp, _sched_cfg(tsched, tm.cfg)).run(
        _requests(tsched, tm.cfg))
    assert _tokens(clean) != _jax_tokens(arch)
