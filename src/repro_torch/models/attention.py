"""GQA attention: chunked online softmax, local (sliding-window) layers,
softcaps, rolling KV caches.

Counterpart of ``repro.models.attention``: training and prefill attention
(one block of full scores for short sequences, the chunked online softmax
otherwise, which never holds an (S x S) score tensor and skips kv blocks
outside the causal window; the reference's training scan visits them
masked, which leaves the result as it is) and the dense decode path.  Both
are plain torch ops, as the reference's are XLA ops.  Decode runs on either
cache layout: the dense one (a row of slots per batch row) and the paged
one of the continuous-batching scheduler (``init_paged_cache``: a shared
block pool addressed through a per-row block table).

Cross-attention (``apply(enc_kv=(k, v))``, the encoder-decoder family):
the queries get no RoPE, the keys and values are the encoder's, prefill
attends to all of them (``causal=False``) and decode reads them from the
layer's ``cross`` cache, each row up to its valid length ``cn`` where the
cache has one (the Scheduler's slots) and the whole buffer otherwise.  The
encoder's own layers (kind "E") attend as the reference's do: causally,
with RoPE (``causal = not cross``).

The decode step writes the new token into the cache in place (the reference
donates its cache buffers, so it too reuses them); callers hand the caches
on and do not read the old ones.

Under a mesh context (``repro_torch.parallel.ctx``) the heads are split over
'model': q, k and v are projected whole (a protected projection needs its
whole operands), then each rank keeps its block of kv heads and the query
heads that read them (``ac``), attends over them alone, with its caches
holding those kv heads only, and gathers the heads back before ``wo``. Each
head's attention is the meshless one, so the split is bitwise.  Where the kv
heads do not divide the axis (multi-query models), the reference splits the
cache length over 'model' (split-K attention, which is not bitwise); the
port runs such attention whole on every 'model' rank and keeps its caches
whole over the axis (``parallel.sharding.cache_shardings``).  A paged pool is
replicated over the dp axes (block tables hold global ids), so a decode step
writes every dp rank's new rows into every copy.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init, linear, rope, softcap
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.ctx import ac

NEG = -1e30


def init(generator, cfg, dtype, device):
    D, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init(generator, D, H * Dh, dtype, device),
        "wk": dense_init(generator, D, KH * Dh, dtype, device),
        "wv": dense_init(generator, D, KH * Dh, dtype, device),
        "wo": dense_init(generator, H * Dh, D, dtype, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * Dh), ("bk", KH * Dh), ("bv", KH * Dh)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    return p


def _scale(cfg) -> float:
    return cfg.attn_scale or cfg.d_head ** -0.5


def _mask(q_pos, k_pos, window, causal=True):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _single_block(q, k, v, *, causal, window, cap):
    """Full scores for short sequences.  q: (B, S, KH, G, Dh)."""
    S, T = q.shape[1], k.shape[1]
    s = torch.einsum("bskgd,btkd->bkgst", q.to(torch.float32),
                     k.to(torch.float32))
    s = softcap(s, cap)
    dev = q.device
    m = _mask(torch.arange(S, device=dev), torch.arange(T, device=dev),
              window, causal)
    s = torch.where(m, s, torch.full((), NEG, device=dev))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))


def chunked_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                      block=512):
    """q: (B, S, H, Dh); k, v: (B, T, KH, Dh) -> (B, S, H, Dh); q
    pre-scaled.  Causal (query i sees keys j <= i) unless ``causal=False``,
    cross-attention's full view of T keys, where S and T may differ.
    kv blocks outside the causal window are skipped (O(S*W) for SWA)."""
    B, S, H, Dh = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    q = q.reshape(B, S, KH, G, Dh)
    if S <= block and T <= block:
        o = _single_block(q, k, v, causal=causal, window=window, cap=cap)
        return o.reshape(B, S, H, Dh).to(v.dtype)

    if S % block or T % block:
        raise ValueError(f"sequence lengths {S}, {T} are not multiples of "
                         f"the attention block {block}")
    nq, nk = S // block, T // block
    w_blocks = -(-window // block) if window else nk
    dev = q.device
    ar = torch.arange(block, device=dev)
    neg = torch.full((), NEG, device=dev)
    outs = []
    for i in range(nq):
        qi = q[:, i * block:(i + 1) * block].to(torch.float32)
        acc = torch.zeros((B, KH, G, block, Dh), device=dev)
        m = torch.full((B, KH, G, block), NEG, device=dev)
        den = torch.zeros((B, KH, G, block), device=dev)
        hi = min(i + 1, nk) if causal else nk
        lo = max(i + 1 - w_blocks, 0) if window else 0
        for j in range(lo, hi):
            kj = k[:, j * block:(j + 1) * block].to(torch.float32)
            vj = v[:, j * block:(j + 1) * block].to(torch.float32)
            s = torch.einsum("bqkgd,bvkd->bkgqv", qi, kj)
            s = softcap(s, cap)
            msk = _mask(i * block + ar, j * block + ar, window, causal)
            s = torch.where(msk, s, neg)
            mj = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - mj[..., None])
            corr = torch.exp(m - mj)
            den = den * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqv,bvkd->bkgqd", p, vj)
            m = mj
        o = acc / torch.clamp(den[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4))       # (B, blk, KH, G, Dh)
    o = torch.cat(outs, dim=1)
    return o.reshape(B, S, H, Dh).to(v.dtype)


def apply(p, x, *, cfg, run, kind, positions, ftc=None, name="attn",
          cache=None, mode="prefill", enc_kv=None):
    """Attention sub-layer; modes "train" (no cache), "prefill" (builds the
    cache) and "decode" (one token).  ``enc_kv``: the encoder's (k, v) for
    cross-attention, whose decode reads the ``cross`` cache ``{"ck", "cv"}``
    (and ``"cn"``, per-row valid lengths, where present) and whose prefill
    builds no cache.  Returns (out, new_cache)."""
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    window = cfg.window if kind == "L" else 0
    cross = enc_kv is not None

    q = linear(x, p["wq"], p.get("bq"), ftc=ftc, name=f"{name}/wq")
    q = q.reshape(*x.shape[:-1], H, Dh)
    if cross:
        k, v = enc_kv
    else:
        k = linear(x, p["wk"], p.get("bk"), ftc=ftc, name=f"{name}/wk")
        v = linear(x, p["wv"], p.get("bv"), ftc=ftc, name=f"{name}/wv")
        k = k.reshape(*x.shape[:-1], KH, Dh)
        v = v.reshape(*x.shape[:-1], KH, Dh)
        k = rope(k, positions, cfg.rope_theta)
        q = rope(q, positions, cfg.rope_theta)
        if heads_split(cfg):
            k = ac(k, "dp", None, "tp", None)
            v = ac(v, "dp", None, "tp", None)
    q = (q * _scale(cfg)).to(x.dtype)
    if heads_split(cfg):
        q = ac(q, "dp", None, "tp", None)

    new_cache = None
    if mode == "decode" and cross:
        ck, cv = cache["ck"], cache["cv"]
        n_valid = cache.get("cn")
        if n_valid is None:              # the whole buffer, a device fill
            n_valid = torch.full((), ck.shape[1], device=x.device)
        o = _decode_attn(q, ck, cv, n_valid, cap=cfg.attn_softcap)
    elif mode == "decode" and "bt" in cache:
        # paged: the row's logical slot maps through its block table to a
        # physical row of the shared pool.  Rows whose table points at the
        # trash block 0 (idle or evicted slots) write where nobody reads.
        pool_k, pool_v, bt = cache["k"], cache["v"], cache["bt"]
        P, bs = pool_k.shape[0], pool_k.shape[1]
        B, eff_cap = bt.shape[0], bt.shape[1] * bs
        pos = positions[:, 0]                                    # (B,)
        slot = pos % window if window else torch.clamp(pos, max=eff_cap - 1)
        rows = torch.arange(B, device=x.device)
        fi = bt[rows, slot // bs].long() * bs + slot % bs        # (B,)
        kp = pool_k.view(P * bs, *pool_k.shape[2:])
        vp = pool_v.view(P * bs, *pool_v.shape[2:])
        fi_all, k_new, v_new = fi, k[:, 0], v[:, 0]
        ctx = pctx.get_ctx()
        if ctx is not None and ctx.rows:
            # the pool is replicated over dp: every copy takes every row
            fi_all, k_new, v_new = (pctx.all_gather(ctx, t, 0, "dp")
                                    for t in (fi, k_new, v_new))
        kp[fi_all] = k_new.to(kp.dtype)
        vp[fi_all] = v_new.to(vp.dtype)
        new_cache = {"k": pool_k, "v": pool_v, "bt": bt}
        # gather each row's blocks back into slot order and run the dense
        # layout's count-masked attention
        flat = (bt.long()[:, :, None] * bs + torch.arange(
            bs, device=x.device)).reshape(B, eff_cap)
        n_valid = torch.clamp(pos + 1, max=window if window else eff_cap)
        o = _decode_attn(q, kp[flat], vp[flat], n_valid,
                         cap=cfg.attn_softcap)
    elif mode == "decode":
        kc, vc = cache["k"], cache["v"]
        cap_len = kc.shape[1]
        pos = positions[:, 0]                                    # (B,)
        slot = pos % cap_len if window else torch.clamp(pos, max=cap_len - 1)
        rows = torch.arange(x.shape[0], device=x.device)
        kc[rows, slot] = k[:, 0].to(kc.dtype)
        vc[rows, slot] = v[:, 0].to(vc.dtype)
        new_cache = {"k": kc, "v": vc}
        n_valid = torch.clamp(pos + 1, max=cap_len)
        o = _decode_attn(q, kc, vc, n_valid, cap=cfg.attn_softcap)
    else:
        o = chunked_attention(q, k, v, causal=not cross, window=window,
                              cap=cfg.attn_softcap, block=run.attn_block)
        if mode == "prefill" and not cross:
            new_cache = _build_cache(k, v, window)
    if heads_split(cfg):
        o = pctx.gather(o, 2, "tp")
    y = linear(o.reshape(*x.shape[:-1], H * Dh), p["wo"], ftc=ftc,
               name=f"{name}/wo")
    return y, new_cache


def heads_split(cfg) -> bool:
    """Whether attention runs on this rank's block of heads: under a mesh
    context whose 'model' axis divides the kv heads."""
    ctx = pctx.get_ctx()
    if ctx is None:
        return False
    return cfg.n_kv_heads % ctx.tp_size == 0


def _decode_attn(q, kc, vc, n_valid, cap=0.0):
    """One-token attention over a cache.  q: (B, 1, H, Dh), kc: (B, C, KH,
    Dh); n_valid: per-row (B,) count of populated cache slots, or one count
    (a 0-d tensor) for every row."""
    B, _, H, Dh = q.shape
    KH = kc.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, Dh).to(torch.float32)
    s = torch.einsum("bkgd,bckd->bkgc", qg, kc.to(torch.float32))
    s = softcap(s, cap)
    valid = (torch.arange(kc.shape[1], device=q.device)[None]
             < n_valid.reshape(-1, 1))
    s = torch.where(valid[:, None, None], s, torch.full((), NEG,
                                                        device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p, vc.to(torch.float32))
    return o.reshape(B, 1, H, Dh).to(vc.dtype)


def _build_cache(k, v, window):
    """Prefill cache: the last ``window`` tokens for local layers in the
    rolling layout (position p at slot p % window), all tokens for global."""
    S = k.shape[1]
    if window and S > window:
        k, v = k[:, -window:], v[:, -window:]
        shift = S % window
        if shift:
            k = torch.roll(k, shift, dims=1)
            v = torch.roll(v, shift, dims=1)
    elif window and S < window:
        pad = (0, 0, 0, 0, 0, window - S)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return {"k": k.contiguous(), "v": v.contiguous()}


def init_cache(cfg, kind, batch, cap_len, dtype, device):
    """Zero cache of one attention layer.  Rolling caches are always
    window-sized: position p lives at slot p % window."""
    window = cfg.window if kind == "L" else 0
    C = window if window else cap_len
    shp = (batch, C, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def init_paged_cache(cfg, kind, batch, cap_len, block_size, n_blocks, dtype,
                     device):
    """Paged cache of one attention layer: a pool of ``n_blocks`` physical
    blocks of ``block_size`` token slots, and a ``(batch, width)`` block
    table mapping each row's logical slots to blocks.  Block 0 is the trash
    block: every entry starts there, and evicted rows are pointed back at
    it.  Rolling (window) layers keep the dense layout's slot map (position
    p at slot p % window), block-indexed; their table is window-sized."""
    window = cfg.window if kind == "L" else 0
    cap = window if window else cap_len
    width = -(-cap // block_size)
    shp = (n_blocks, block_size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device),
            "bt": torch.zeros((batch, width), dtype=torch.int32,
                              device=device)}
