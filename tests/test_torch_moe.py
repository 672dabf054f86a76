"""The port's MoE block against the reference's, on reduced
qwen3-moe-235b-a22b (4 experts, top-2).

  * ``_local_moe`` on the same float32 inputs, at capacity factor 1.25
    and 8.0, on tests/test_moe.py's (2, 16) tokens and on 4 of them as a
    B = 4 decode step's (4, 1), where capacity 1.25 drops assignments
    (capacity 2, and 4 of the 8 go to expert 0: 2 dropped): the top-k
    experts and the kept (token, expert, slot) table equal the
    reference's; output and aux loss within rtol 1e-5, atol 1e-6.  In
    bf16 (bf16 tokens and experts, the float32 router) the output is
    within one bf16 ulp of the reference's.
  * Ties in the router go to the lower expert index, as ``jax.lax.top_k``.
  * The port passes the four properties of tests/test_moe.py: the
    per-token reference, expert partitions summing to the whole, capacity
    drops, and an aux loss near 1 for a uniform router.
  * ``Model.loss`` of the reduced model (float32) is the reference's
    ``nll + aux`` within 1e-5, and its aux term is not 0.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRun
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.convert import cnn_params_from_jax, params_from_jax
from repro_torch.models import build as tbuild
from repro_torch.models import moe as tmoe

# one intra-op thread: the suite runs in parallel worker processes, and
# torch's spinning OpenMP pool would take their cores
torch.set_num_threads(1)

ARCH = "qwen3-moe-235b-a22b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
RTOL, ATOL = 1e-5, 1e-6


def _cfgs(cap_factor):
    jcfg, tcfg = jget_config(ARCH, reduced=True), get_config(ARCH,
                                                             reduced=True)
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cap_factor)) for c in (jcfg, tcfg))


@functools.cache
def _setup(cap_factor=8.0, dtype="float32", tokens="prefill"):
    """(jax cfg, port cfg, jax params, port params, jax x, port x) as in
    tests/test_moe.py: (2, 16, D) tokens, or their first 2 of each row as
    (4, 1, D) ``tokens="decode"``; the router stays float32."""
    jcfg, tcfg = _cfgs(cap_factor)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jmoe.init(jax.random.PRNGKey(0), jcfg, jdt)
    jx = jax.random.normal(jax.random.PRNGKey(1), (2, 16, jcfg.d_model)
                           ).astype(jdt)
    if tokens == "decode":
        jx = jx[:, :2].reshape(4, 1, jcfg.d_model)
    # leaf by leaf, bf16 included (the CNN converter takes any tree)
    tp = cnn_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tx = cnn_params_from_jax({"x": np.asarray(jx)}, device="cpu")["x"]
    return jcfg, tcfg, jp, tp, jx, tx


def _jax_logits(p, x):
    return x.astype(jnp.float32) @ p["router"]


def _capacity(cfg, x):
    m = cfg.moe
    return max(int(m.capacity_factor * x.shape[0] * x.shape[1] * m.top_k
                   / m.n_experts), 1)


def _run(cap_factor, dtype="float32", router=None, tokens="prefill"):
    jcfg, tcfg, jp, tp, jx, tx = _setup(cap_factor, dtype, tokens)
    if router is not None:
        jp = dict(jp, router=jnp.asarray(router))
        tp = dict(tp, router=torch.from_numpy(router))
    m = jcfg.moe
    kw = dict(e0=0, n_experts=m.n_experts, top_k=m.top_k,
              capacity=_capacity(jcfg, jx), act_name=jcfg.act)
    jl = _jax_logits(jp, jx)
    want = jax.jit(functools.partial(jmoe._local_moe, **kw))(
        jx, jl, jp["wi"], jp["wg"], jp["wo"])
    tl = torch.from_numpy(np.array(jl))
    got = tmoe._local_moe(tx, tl, tp["wi"], tp["wg"], tp["wo"], **kw)
    return want, got, jl, tl, kw


def _jax_route(logits, top_k, capacity, E):
    """The reference's dispatch (repro/models/moe.py, ``_local_moe``), its
    lines up to the slot of each assignment: (topi, kept (token, expert,
    slot) rows)."""
    @jax.jit
    def route(logits):
        T = logits.shape[0]
        probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        _, topi = jax.lax.top_k(probs, top_k)
        flat_e = topi.reshape(-1)
        flat_tok = jnp.repeat(jnp.arange(T), top_k)
        order = jnp.argsort(flat_e, stable=True)
        srel = flat_e[order]
        pos = jnp.arange(T * top_k) - jnp.searchsorted(srel, srel,
                                                       side="left")
        keep = (srel < E) & (pos < capacity)
        slot = jnp.where(keep, srel * capacity + pos, E * capacity)
        return topi, jnp.stack([flat_tok[order], srel, slot], 1), keep
    topi, rows, keep = route(logits)
    return np.asarray(topi), np.asarray(rows)[np.asarray(keep)]


def _port_table(r):
    """The port's kept (token, expert, slot) rows, in dispatch order."""
    expert = r["topi"].reshape(-1)[r["order"]]
    return np.stack([r["tok"].numpy(), expert.numpy(), r["slot"].numpy()],
                    1)[r["keep"].numpy()]


@pytest.mark.parametrize("tokens", ("prefill", "decode"))
@pytest.mark.parametrize("cap_factor", (1.25, 8.0))
def test_local_moe_equals_reference(cap_factor, tokens):
    want, got, jl, tl, kw = _run(cap_factor, tokens=tokens)
    T = jl.shape[0] * jl.shape[1]
    topi, rows = _jax_route(jl.reshape(T, -1), kw["top_k"], kw["capacity"],
                            kw["n_experts"])
    r = tmoe._route(tl.reshape(T, -1), e0=0, E_local=kw["n_experts"],
                    top_k=kw["top_k"], capacity=kw["capacity"])
    np.testing.assert_array_equal(r["topi"].numpy(), topi)
    np.testing.assert_array_equal(_port_table(r), rows)
    dropped = T * kw["top_k"] - len(rows)
    assert dropped == (2 if (cap_factor, tokens) == (1.25, "decode") else 0)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("tokens", ("prefill", "decode"))
@pytest.mark.parametrize("cap_factor", (1.25, 8.0))
def test_local_moe_bf16_within_one_ulp(cap_factor, tokens):
    """bf16 tokens and experts: the reference's return path adds the top-k
    gathers in bf16, one at a time; so does the port."""
    want, got, _, _, _ = _run(cap_factor, "bfloat16", tokens=tokens)
    w = np.asarray(want[0].astype(jnp.float32))
    g = got[0].to(torch.float32).numpy()
    big = np.maximum(np.abs(w), np.abs(g))
    # one bf16 ulp at each element's magnitude (8 significant bits)
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert (np.abs(w - g) <= ulp).all(), np.abs(w - g).max()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)


def test_router_ties_go_to_the_lower_index():
    """Equal router rows: every probability ties, and the top-k are the
    lowest expert indices, as jax.lax.top_k's."""
    _, _, jl, tl, kw = _run(8.0, router=np.zeros((64, 4), np.float32))
    T = jl.shape[0] * jl.shape[1]
    topi, rows = _jax_route(jl.reshape(T, -1), kw["top_k"], kw["capacity"],
                            kw["n_experts"])
    r = tmoe._route(tl.reshape(T, -1), e0=0, E_local=kw["n_experts"],
                    top_k=kw["top_k"], capacity=kw["capacity"])
    assert (topi == np.arange(kw["top_k"])).all()
    np.testing.assert_array_equal(r["topi"].numpy(), topi)
    np.testing.assert_array_equal(_port_table(r), rows)


# --------------------------------------- tests/test_moe.py's properties --
def _per_token(cfg, p, x):
    m = cfg.moe
    x2 = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(x2 @ p["router"], -1)
    tw, ti = torch.topk(probs, m.top_k)
    tw = tw / tw.sum(-1, keepdim=True)
    out = torch.zeros_like(x2)
    for t in range(x2.shape[0]):
        for kk in range(m.top_k):
            e = int(ti[t, kk])
            h = (torch.nn.functional.silu(x2[t] @ p["wi"][e])
                 * (x2[t] @ p["wg"][e]))
            out[t] += tw[t, kk] * (h @ p["wo"][e])
    return out.reshape(x.shape)


def _port(cap=None, lo=0, hi=None, router=None):
    _, cfg, _, p, _, x = _setup()
    m = cfg.moe
    hi = m.n_experts if hi is None else hi
    if router is not None:
        p = dict(p, router=router)
    cap = int(8.0 * x.shape[0] * x.shape[1] * m.top_k / m.n_experts) + 1 \
        if cap is None else cap
    return tmoe._local_moe(x, x @ p["router"], p["wi"][lo:hi],
                           p["wg"][lo:hi], p["wo"][lo:hi], e0=lo,
                           n_experts=m.n_experts, top_k=m.top_k,
                           capacity=cap, act_name=cfg.act)


def test_port_matches_per_token_reference():
    _, cfg, _, p, _, x = _setup()
    np.testing.assert_allclose(_port()[0].numpy(),
                               _per_token(cfg, p, x).numpy(), atol=1e-4)


def test_port_expert_partitions_sum_to_whole():
    E_half = get_config(ARCH, reduced=True).moe.n_experts // 2
    y0, y1 = _port(hi=E_half)[0], _port(lo=E_half)[0]
    np.testing.assert_allclose((y0 + y1).numpy(), _port()[0].numpy(),
                               atol=1e-4)


def test_port_capacity_drops_tokens():
    _, cfg, _, p, _, x = _setup()
    y, _ = _port(cap=1)
    assert (y - _per_token(cfg, p, x)).abs().max() > 1e-3
    assert torch.isfinite(y).all()


def test_port_aux_loss_near_one_for_uniform_router():
    _, _, _, p, _, _ = _setup()
    _, lb = _port(router=torch.zeros_like(p["router"]))
    assert abs(float(lb[0]) - 1.0) < 0.2


# --------------------------------------------------------------- the loss --
def test_model_loss_adds_the_aux_term():
    jcfg, tcfg = jget_config(ARCH, reduced=True), get_config(ARCH,
                                                            reduced=True)
    jm, tm = jbuild(jcfg, JRun(**F32)), tbuild(tcfg, TRun(**F32))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 12))
    jloss, jmet = jax.jit(lambda p, b: jm.loss(p, b))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        tloss, tmet = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    assert float(tmet["aux"]) > 0
    for w, g in ((jloss, tloss), (jmet["nll"], tmet["nll"]),
                 (jmet["aux"], tmet["aux"])):
        assert abs(float(w) - float(g)) <= 1e-5, (float(w), float(g))


def test_mesh_is_refused():
    """A mesh is not an argument: as in the reference, apply reads it from
    the mesh context (expert parallelism: tests/test_torch_sharded.py)."""
    _, cfg, _, p, _, x = _setup()
    with pytest.raises(TypeError, match="mesh"):
        tmoe.apply(p, x, cfg, mesh=object())
