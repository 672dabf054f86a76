"""Mixture-of-Experts FFN with partial-sum expert parallelism.
Counterpart of ``repro.models.moe``.

The router is the one protected site: it runs through ``common.linear``
on float32 operands (``x`` cast to float32, float32 router weights), so
under a policy its operands reach the fault-tolerant datapath unrounded.
The expert einsums stay clean, as in the reference.  Dispatch is the
reference's, order for order: top-k by a stable descending sort (ties go
to the lower expert index), a stable argsort of the assignments by expert,
each assignment's position in its expert from ``searchsorted``, capacity
``max(int(cf * T * k / E), 1)`` (assignments past it are dropped), a
slot-to-token table with the sentinel row ``n_slots``, and a return path
that adds the ``top_k`` gathers one at a time in the compute dtype.  Every
shape is static and nothing syncs with the host, so a decode step that
holds an MoE layer captures as one CUDA graph.

Expert parallelism, under a mesh context (``repro_torch.parallel.ctx``),
as the reference's shard_map region: the experts live on the 'model' axis
(each rank holds ``n_experts / tp`` of them, ``parallel.sharding.
keep_experts``), the tokens are the rank's dp rows, replicated over
'model'.  Each rank routes its rows, keeps the assignments that hit its
own experts (``e0 = rank * E / tp``), runs them on buffers of the capacity
its local token count gives, and the partial outputs are summed over
'model' (``psum``, the one collective).  A batch the dp axes do not split
runs the whole block on every rank with the experts gathered, as the
reference's replicated branch.  The router stays outside, under the fault
layer, row-local.  The capacity is per shard, so the routed sets equal the
meshless ones only with room for every assignment (``capacity_factor``
high enough: 8 in the tests).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init, linear
from repro_torch.parallel import ctx as pctx


def init(generator, cfg, dtype, device):
    D, m = cfg.d_model, cfg.moe
    p = {"router": dense_init(generator, D, m.n_experts, torch.float32,
                              device),
         "wi": _expert_init(generator, m.n_experts, D, m.d_ff, dtype, device),
         "wo": _expert_init(generator, m.n_experts, m.d_ff, D, dtype,
                            device)}
    if cfg.glu:
        p["wg"] = _expert_init(generator, m.n_experts, D, m.d_ff, dtype,
                               device)
    return p


def _expert_init(generator, E, d_in, d_out, dtype, device):
    """(E, d_in, d_out): one ``dense_init`` matrix per expert (on the meta
    device, the shape alone: there is nothing to draw)."""
    if torch.device(device).type == "meta":
        return torch.empty((E, d_in, d_out), dtype=dtype, device=device)
    return torch.stack([dense_init(generator, d_in, d_out, dtype, device)
                        for _ in range(E)])


def _top_k(probs, k):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort keeps index order in a tie)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits, *, e0, E_local, top_k, capacity):
    """The dispatch of T tokens' router ``logits`` (T, E): the softmax
    ``probs``, the renormalized top-k weights and experts ``topw, topi``
    (T, k), and per assignment (T * k of them, sorted stably by local
    expert through ``order``) its token ``tok``, whether it is kept
    (``keep``: a local expert within capacity) and its buffer ``slot`` (the
    sentinel ``n_slots`` when dropped)."""
    T = logits.shape[0]
    dev = logits.device
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    topw, topi = _top_k(probs, top_k)                         # (T, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    rel = topi.reshape(-1) - e0                               # (T*k,)
    mine = (rel >= 0) & (rel < E_local)
    sort_key = torch.where(mine, rel, torch.full_like(rel, E_local))
    order = torch.argsort(sort_key, stable=True)
    srel = sort_key[order]
    pos = (torch.arange(T * top_k, device=dev)
           - torch.searchsorted(srel, srel, side="left"))
    keep = (srel < E_local) & (pos < capacity)
    slot = torch.where(keep, srel * capacity + pos,
                       torch.full_like(srel, E_local * capacity))
    tok = (torch.arange(T * top_k, device=dev) // top_k)[order]
    return dict(probs=probs, topw=topw, topi=topi, order=order, tok=tok,
                keep=keep, slot=slot)


def _local_moe(x, logits, wi, wg, wo, *, e0, n_experts, top_k, capacity,
               act_name, tp_axis=None):
    """MoE over the experts ``[e0, e0 + E_local)`` held here.  x: (B, S,
    D); logits: (B, S, E), the router's.  With ``tp_axis`` the output is
    this rank's part, summed over the axis (each rank's inputs feed only
    its experts, so their gradients sum over it too).  Returns (y (B, S,
    D), the Switch load-balance loss (1,))."""
    B, S, D = x.shape
    E_local = wi.shape[0]
    T = B * S
    dev = x.device
    x2 = x.reshape(T, D)
    act = activation(act_name)
    r = _route(logits.reshape(T, -1), e0=e0, E_local=E_local, top_k=top_k,
               capacity=capacity)
    probs, topw, topi, slot = r["probs"], r["topw"], r["topi"], r["slot"]
    if tp_axis is not None:
        x2, topw = pctx.tp_copy(x2, tp_axis), pctx.tp_copy(topw, tp_axis)

    # slot -> token table; every dropped assignment writes the sentinel
    # row n_slots, which the buffer never reads
    n_slots = E_local * capacity
    slot_tok = torch.full((n_slots + 1,), T, dtype=torch.int64, device=dev)
    slot_tok.scatter_(0, slot, r["tok"])
    slot_tok = slot_tok[:n_slots]
    slot_valid = slot_tok < T
    x2p = torch.cat([x2, x2.new_zeros((1, D))], 0)
    buf = (x2p[slot_tok] * slot_valid[:, None].to(x2.dtype)).reshape(
        E_local, capacity, D)

    h = torch.einsum("ecd,edf->ecf", buf, wi)
    if wg is not None:
        h = act(h) * torch.einsum("ecd,edf->ecf", buf, wg)
    else:
        h = act(h)
    y = torch.einsum("ecf,efd->ecd", h, wo).reshape(n_slots, D)
    y = torch.cat([y, y.new_zeros((1, D))], 0)

    # return path: (token, k) -> slot, then k gathers added one at a time
    slot_of = torch.empty_like(slot)
    slot_of[r["order"]] = slot
    slot_of = slot_of.reshape(T, top_k)
    out = torch.zeros((T, D), dtype=y.dtype, device=dev)
    for kk in range(top_k):
        out = out + y[slot_of[:, kk]] * topw[:, kk, None].to(y.dtype)
    if tp_axis is not None:
        out = pctx.psum(out, tp_axis)

    # Switch-style load-balance loss
    # (one_hot reads its input's range on the host; a comparison does not)
    one_hot_top1 = (topi[:, 0, None] == torch.arange(
        n_experts, device=dev)).to(torch.float32)
    frac = one_hot_top1.mean(0)
    lb = n_experts * torch.sum(frac * probs.mean(0))
    return out.reshape(B, S, D), lb.reshape(1)


def apply(p, x, cfg, ftc=None, name="moe"):
    """Returns (y, aux_loss_scalar); expert-parallel under a mesh
    context."""
    m = cfg.moe
    ctx = pctx.get_ctx()
    wi, wg, wo = p["wi"], p.get("wg"), p["wo"]
    # the router under the fault layer, on float32 operands
    logits = linear(x.to(torch.float32), p["router"], ftc=ftc,
                    name=f"{name}/router")
    one = dict(n_experts=m.n_experts, top_k=m.top_k, act_name=cfg.act)
    T = x.shape[0] * x.shape[1]
    cap = max(int(m.capacity_factor * T * m.top_k / m.n_experts), 1)
    if ctx is not None and ctx.rows and m.n_experts % ctx.tp_size == 0:
        # T is this rank's rows: the capacity of the local token count
        E_local = m.n_experts // ctx.tp_size
        y, lb = _local_moe(x, logits, wi, wg, wo,
                           e0=ctx.coord(ctx.tp) * E_local, capacity=cap,
                           tp_axis="tp", **one)
        return y, m.aux_coef * lb.mean()
    if ctx is not None and wi.shape[0] != m.n_experts:
        # a batch the dp axes do not split: every rank runs the whole block
        wi, wo = pctx.gather(wi, 0, "tp"), pctx.gather(wo, 0, "tp")
        wg = None if wg is None else pctx.gather(wg, 0, "tp")
    y, lb = _local_moe(x, logits, wi, wg, wo, e0=0, capacity=cap, **one)
    return y, m.aux_coef * lb.mean()
