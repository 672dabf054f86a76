"""Decoder LM assembly over heterogeneous layers.

Counterpart of ``repro.models.transformer`` for the decoder families: G
global and L local attention, R RG-LRU and S Mamba2 SSD mixers, with a
dense (G)LU or an MoE feed-forward block.  Layers are kept as one dict per
layer (``layers/l{i}``) whatever the config; the reference's layer *names*,
which key every fault draw, follow its layout: ``l{i}`` for unrolled
configs and ``sb{si}/s{j}`` for scanned ones, where the scan body is traced
once, so every layer of a segment shares its site names and fault keys.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, mlp, moe, rglru, ssm
from repro_torch.models.common import dtype_of, embed_init, rms_norm, softcap

# the mixer of each layer kind, and its key in the layer's params and cache
MIXERS = {"G": (attention, "attn"), "L": (attention, "attn"),
          "R": (rglru, "rglru"), "S": (ssm, "ssd")}


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
def init_layer(generator, cfg, kind, dtype, device):
    _check_kind(kind)
    if cfg.enc_dec:
        raise NotImplementedError("encoder-decoder layers are not ported "
                                  "yet (ROADMAP.md, queue A item 4.4)")
    D = cfg.d_model
    mixer, key = MIXERS[kind]
    p = {"ln1": torch.zeros((D,), device=device),
         key: mixer.init(generator, cfg, dtype, device)}
    if cfg.post_norm:
        p["ln1_post"] = torch.zeros((D,), device=device)
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
        f"l{i}": init_layer(generator, cfg, kind, dtype, device)
        for i, kind in enumerate(layer_kinds(cfg))}
    return params


# ----------------------------------------------------------------- layer ---
def apply_layer(p, x, *, kind, cfg, run, mode, cache=None, positions=None,
                ftc=None, name="blk"):
    """One residual layer.  Returns (x, new_cache, aux_loss): the cache is
    ``{"attn": ...}``, ``{"rglru": ...}`` or ``{"ssd": ...}`` by kind, and
    the aux loss is the MoE block's load-balance term (0 without one)."""
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
    return x, {key: c}, aux


# -------------------------------------------------------------- backbone ---
def backbone(params, x, *, cfg, run, mode, caches=None, positions=None,
             ftc=None):
    """Apply all layers.  Returns (hidden, new_caches, aux_loss_sum); no
    caches in mode "train", where ``run.remat == "block"`` recomputes each
    layer in the backward pass instead of keeping its activations
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of a
    scanned block).  The recompute draws the same fault keys, so a faulty
    forward recomputes bit for bit."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    train = mode == "train"
    new_caches = {}
    aux_total = torch.zeros((), device=x.device)
    for i, (kind, name) in enumerate(zip(layer_kinds(cfg), layer_names(cfg))):
        lid = f"l{i}"
        if train:
            def layer(p, h, kind=kind, name=name):
                y, _, a = apply_layer(p, h, kind=kind, cfg=cfg, run=run,
                                      mode=mode, positions=positions,
                                      ftc=ftc, name=name)
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
            positions=positions, ftc=ftc, name=name)
        aux_total = aux_total + aux
    return x, (None if train else new_caches), aux_total


# ------------------------------------------------------------- embedding ---
def embed_tokens(params, cfg, tokens):
    e = params["embed"][tokens]
    if cfg.scale_embeds:
        # a device fill, not a host tensor: a graphed decode step holds it
        e = e * torch.full((), cfg.d_model ** 0.5, dtype=e.dtype,
                           device=e.device)
    return e


def assemble_inputs(params, cfg, batch):
    """Token-only input embedding (the frontends come with their families).
    Returns (x, labels, mask)."""
    if cfg.frontend or cfg.enc_dec:
        raise NotImplementedError(f"{cfg.frontend or 'encoder'} inputs are "
                                  "not ported yet")
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    labels = tokens[:, 1:]
    return x, labels, torch.ones_like(labels, dtype=torch.bool)


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
