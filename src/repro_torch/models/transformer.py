"""Decoder LM and encoder-decoder assembly over heterogeneous layers.

Counterpart of ``repro.models.transformer``: G global and L local
attention, R RG-LRU and S Mamba2 SSD mixers, with a dense (G)LU or an MoE
feed-forward block; the encoder-decoder family's encoder stack (kind E)
and its decoder layers' cross-attention block; the vision family's patch
embeddings in front of the tokens.  Layers are kept as one dict per layer
(``layers/l{i}``, ``enc_layers/l{i}``) whatever the config; the
reference's layer *names*, which key every fault draw, follow its layout:
``l{i}`` and ``enc{i}`` for unrolled configs and ``sb{si}/s{j}`` for
scanned ones, where the scan body is traced once, so every layer of a
segment shares its site names and fault keys.  The reference's scanned
encoder passes no fault context at all: at full width (``unroll=False``)
the encoder is clean float math and only the decoder's projections are
protected.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, mlp, moe, rglru, ssm
from repro_torch.models.common import (dtype_of, embed_init, linear,
                                       rms_norm, softcap)
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.ctx import ac

# the mixer of each layer kind, and its key in the layer's params and cache
MIXERS = {"G": (attention, "attn"), "L": (attention, "attn"),
          "E": (attention, "attn"), "R": (rglru, "rglru"), "S": (ssm, "ssd")}


def layer_kinds(cfg):
    return list(cfg.block_pattern) * cfg.n_blocks + list(cfg.tail)


def layer_names(cfg):
    """Site-name prefix of each layer, in layer order."""
    if cfg.unroll:
        return [f"l{i}" for i in range(cfg.n_layers)]
    return [f"sb{si}/s{j}" for si, (pattern, n_rep) in enumerate(cfg.segments)
            for _ in range(n_rep) for j in range(len(pattern))]


def _check_kind(kind):
    if kind not in MIXERS:
        raise NotImplementedError(f"layer kind {kind!r} comes with its "
                                  "model family (ROADMAP.md)")


# ------------------------------------------------------------------ init ---
def init_layer(generator, cfg, kind, dtype, device, cross=False):
    """One layer's parameters; ``cross`` adds the cross-attention block
    (``lnx``, ``xattn``) of an encoder-decoder's decoder layer."""
    _check_kind(kind)
    D = cfg.d_model
    mixer, key = MIXERS[kind]
    p = {"ln1": torch.zeros((D,), device=device),
         key: mixer.init(generator, cfg, dtype, device)}
    if cfg.post_norm:
        p["ln1_post"] = torch.zeros((D,), device=device)
    if cross:
        p["lnx"] = torch.zeros((D,), device=device)
        p["xattn"] = attention.init(generator, cfg, dtype, device)
    if cfg.d_ff > 0 or cfg.moe is not None:
        p["ln2"] = torch.zeros((D,), device=device)
        p["ffn"] = (moe.init(generator, cfg, dtype, device)
                    if cfg.moe is not None
                    else mlp.init(generator, cfg, dtype, device))
        if cfg.post_norm:
            p["ln2_post"] = torch.zeros((D,), device=device)
    return p


def init_params(generator, cfg, run, device):
    dtype = dtype_of(run.param_dtype)
    params = {"embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype,
                                  device),
              "final_norm": torch.zeros((cfg.d_model,), device=device)}
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(generator, cfg.vocab, cfg.d_model,
                                       dtype, device)
    params["layers"] = {
        f"l{i}": init_layer(generator, cfg, kind, dtype, device,
                            cross=cfg.enc_dec)
        for i, kind in enumerate(layer_kinds(cfg))}
    if cfg.enc_dec:
        params["enc_layers"] = {
            f"l{i}": init_layer(generator, cfg, "E", dtype, device)
            for i in range(cfg.n_enc_layers)}
        params["enc_norm"] = torch.zeros((cfg.d_model,), device=device)
    return params


# ----------------------------------------------------------------- layer ---
def apply_layer(p, x, *, kind, cfg, run, mode, cache=None, positions=None,
                ftc=None, name="blk", enc_out=None):
    """One residual layer.  Returns (x, new_cache, aux_loss): the cache is
    ``{"attn": ...}``, ``{"rglru": ...}`` or ``{"ssd": ...}`` by kind, with
    a decoder layer's ``{"cross": {"ck", "cv"[, "cn"]}}`` beside it, and the
    aux loss is the MoE block's load-balance term (0 without one).  A
    cross-attention block takes its keys and values from ``enc_out``
    (prefill, train) or from the ``cross`` cache (decode)."""
    _check_kind(kind)
    mixer, key = MIXERS[kind]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    kw = dict(kind=kind) if mixer is attention else {}
    m, c = mixer.apply(p[key], h, cfg=cfg, run=run, positions=positions,
                       ftc=ftc, name=f"{name}/{key}", mode=mode,
                       cache=None if cache is None else cache[key], **kw)
    if cfg.post_norm:
        m = rms_norm(m, p["ln1_post"], cfg.norm_eps)
    x = x + m
    new_cache = {key: c}
    ek = None if cache is None else cache.get("cross")
    if "xattn" in p and (enc_out is not None or ek is not None):
        h = rms_norm(x, p["lnx"], cfg.norm_eps)
        if ek is None:
            ek = dict(zip(("ck", "cv"), _cross_kv(p["xattn"], enc_out, cfg,
                                                  ftc, name)))
        m, _ = attention.apply(p["xattn"], h, cfg=cfg, run=run, kind="G",
                               positions=positions, ftc=ftc,
                               name=f"{name}/xattn", mode=mode,
                               cache=ek if mode == "decode" else None,
                               enc_kv=(ek["ck"], ek["cv"]))
        new_cache["cross"] = ek
        x = x + m
    aux = torch.zeros((), device=x.device)
    if "ffn" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.moe is not None:
            f, aux = moe.apply(p["ffn"], h, cfg, ftc=ftc, name=f"{name}/moe")
        else:
            f = mlp.apply(p["ffn"], h, cfg, ftc=ftc, name=f"{name}/mlp")
        if cfg.post_norm:
            f = rms_norm(f, p["ln2_post"], cfg.norm_eps)
        x = x + f
    return x, new_cache, aux


def _cross_kv(pa, enc_out, cfg, ftc, name):
    """The encoder's keys and values for one decoder layer: sites
    ``{name}/xk`` and ``{name}/xv``, at M = B x the encoder's length."""
    KH, Dh = cfg.n_kv_heads, cfg.d_head
    k = linear(enc_out, pa["wk"], pa.get("bk"), ftc=ftc, name=f"{name}/xk")
    v = linear(enc_out, pa["wv"], pa.get("bv"), ftc=ftc, name=f"{name}/xv")
    k = k.reshape(*enc_out.shape[:-1], KH, Dh)
    v = v.reshape(*enc_out.shape[:-1], KH, Dh)
    if attention.heads_split(cfg):
        k, v = ac(k, "dp", None, "tp", None), ac(v, "dp", None, "tp", None)
    return k, v


# -------------------------------------------------------------- backbone ---
def backbone(params, x, *, cfg, run, mode, caches=None, positions=None,
             ftc=None, enc_out=None):
    """Apply all layers.  Returns (hidden, new_caches, aux_loss_sum); no
    caches in mode "train", where ``run.remat == "block"`` recomputes each
    layer in the backward pass instead of keeping its activations
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of a
    scanned block).  The recompute draws the same fault keys, so a faulty
    forward recomputes bit for bit, and under the forward's mesh context
    (the backward runs outside it)."""
    B, S, _ = x.shape
    ctx = pctx.get_ctx()
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    train = mode == "train"
    new_caches = {}
    aux_total = torch.zeros((), device=x.device)
    for i, (kind, name) in enumerate(zip(layer_kinds(cfg), layer_names(cfg))):
        lid = f"l{i}"
        if train:
            def layer(p, h, kind=kind, name=name):
                with pctx.mesh_ctx(ctx):
                    y, _, a = apply_layer(p, h, kind=kind, cfg=cfg, run=run,
                                          mode=mode, positions=positions,
                                          ftc=ftc, name=name,
                                          enc_out=enc_out)
                return y, a
            p = params["layers"][lid]
            if run.remat == "block" and torch.is_grad_enabled():
                # the fault draws are counter-based: no RNG state to keep
                x, aux = checkpoint(layer, p, x, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = layer(p, x)
            aux_total = aux_total + aux
            continue
        x, new_caches[lid], aux = apply_layer(
            params["layers"][lid], x, kind=kind, cfg=cfg, run=run, mode=mode,
            cache=None if caches is None else caches[lid],
            positions=positions, ftc=ftc, name=name, enc_out=enc_out)
        aux_total = aux_total + aux
    return x, (None if train else new_caches), aux_total


def encode(params, frames, *, cfg, run, ftc=None):
    """The encoder stack over precomputed frontend frame embeddings (B, T,
    D), then ``enc_norm``.  Unrolled configs run each layer under ``ftc``
    with site names ``enc{i}``; scanned ones, as the reference's scan body,
    with no fault context (clean float math).  Under ``run.remat ==
    "block"`` a training forward recomputes each layer in the backward
    pass."""
    B, T, _ = frames.shape
    positions = torch.arange(T, device=frames.device).expand(B, T)
    lctx = ftc if cfg.unroll else None
    mctx = pctx.get_ctx()
    x = frames
    for i in range(cfg.n_enc_layers):
        def layer(p, h, name=f"enc{i}" if cfg.unroll else "enc"):
            with pctx.mesh_ctx(mctx):
                return apply_layer(p, h, kind="E", cfg=cfg, run=run,
                                   mode="train", positions=positions,
                                   ftc=lctx, name=name)[0]
        p = params["enc_layers"][f"l{i}"]
        if run.remat == "block" and torch.is_grad_enabled():
            x = checkpoint(layer, p, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(p, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


# ------------------------------------------------------------- embedding ---
def embed_tokens(params, cfg, tokens):
    e = params["embed"][tokens]
    if cfg.scale_embeds:
        # a device fill, not a host tensor: a graphed decode step holds it
        e = e * torch.full((), cfg.d_model ** 0.5, dtype=e.dtype,
                           device=e.device)
    return e


def assemble_inputs(params, cfg, batch):
    """The family's input embedding.  Returns (x, labels, mask, enc_out),
    labels and mask aligned to predict ``labels[t]`` from ``hidden[t]``.
    The vision family puts its ``patch_embeds`` (B, P, D), in the compute
    dtype and scaled as the tokens are, in front of the tokens, and labels
    the first P - 1 positions -1 (masked out); the encoder-decoder family's
    ``frames`` (B, T, D) become ``enc_out`` (None otherwise), the encoder's
    input."""
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    if cfg.frontend == "vision":
        patches = batch["patch_embeds"].to(x.dtype)
        if cfg.scale_embeds:
            patches = patches * torch.full((), cfg.d_model ** 0.5,
                                           dtype=x.dtype, device=x.device)
        x = torch.cat([patches, x], dim=1)
        B, P = patches.shape[:2]
        labels = torch.cat([torch.full((B, P - 1), -1, dtype=tokens.dtype,
                                       device=tokens.device), tokens], dim=1)
        mask = labels >= 0
    else:
        labels = tokens[:, 1:]
        mask = torch.ones_like(labels, dtype=torch.bool)
    enc_out = batch["frames"].to(x.dtype) if cfg.enc_dec else None
    return x, labels, mask, enc_out


# ------------------------------------------------------------------ loss ---
def _xent_chunk(hc, lc, mc, emb, cap):
    """(sum of the chunk's masked token NLLs, its count of real tokens)."""
    logits = softcap(hc.to(torch.float32) @ emb.to(torch.float32).T, cap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, lc.clamp(min=0).unsqueeze(-1),
                              dim=-1)[..., 0]
    m = mc.to(torch.float32)
    return ((lse - ll) * m).sum(), m.sum()


def chunked_xent(params, cfg, run, h, labels, mask):
    """Mean cross-entropy of ``labels`` over ``mask``, the (tokens, vocab)
    logits formed ``run.loss_chunk`` tokens at a time (float32, bf16
    products exact) and summed chunk by chunk in the reference's order;
    each chunk's logits are recomputed in the backward pass."""
    emb = params.get("unembed", params["embed"])
    Sm = labels.shape[1]
    hs = h[:, :Sm]
    C = min(run.loss_chunk, Sm)
    n = -(-Sm // C)
    pad = n * C - Sm
    if pad:
        hs = torch.nn.functional.pad(hs, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        mask = torch.nn.functional.pad(mask, (0, pad))
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for i in range(n):
        args = (hs[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C],
                mask[:, i * C:(i + 1) * C], emb, cfg.logit_softcap)
        if torch.is_grad_enabled():
            nll, m = checkpoint(_xent_chunk, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            nll, m = _xent_chunk(*args)
        tot, cnt = tot + nll, cnt + m
    return tot / torch.clamp(cnt, min=1.0)


def last_logits(params, cfg, h, index=None):
    """float32 logits at the last position, or, for right-padded (bucketed)
    prompts, at a per-row ``index`` (B,) of the last real token."""
    emb = params.get("unembed", params["embed"])
    hl = h[:, -1] if index is None else h[
        torch.arange(h.shape[0], device=h.device),
        torch.as_tensor(index, device=h.device).long()]
    logits = hl.to(torch.float32) @ emb.to(torch.float32).T
    return softcap(logits, cfg.logit_softcap)
