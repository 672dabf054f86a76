"""RG-LRU recurrent block (RecurrentGemma / Griffin).  Counterpart of
``repro.models.rglru``.

Gated linear recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
with a_t = exp(-c * softplus(Lambda) * r_t).  The recurrence and input
gates are block-diagonal linears (one (bw, bw) block per head) and stay
clean; the protected sites are ``w_gate``, ``w_x`` and ``w_out``.  Train
and prefill run the recurrence as ``jax.lax.associative_scan`` does, pair
for pair (``_recurrence``); decode is an O(1) state update, written into
the cache in place (the decode step of a CUDA graph owns its caches).

Under a mesh context whose 'model' axis divides the heads, the block runs
on this rank's block of the width (``ac``): its conv channels, its gate
heads, its state rows, which its caches hold; ``w_out`` takes the width
gathered back.  Every op of the block is per channel or per head, so the
split is bitwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, linear
from repro_torch.models.ssm import _causal_conv as _conv, softplus
from repro_torch.parallel.ctx import ac, ag

C_FACTOR = 8.0


def _gate_init(generator, heads, bw, dtype, device):
    return torch.stack([dense_init(generator, bw, bw, dtype, device)
                        for _ in range(heads)])


def init(generator, cfg, dtype, device):
    D, W = cfg.d_model, cfg.rglru_width
    nh = max(cfg.n_heads, 1)
    assert W % nh == 0
    bw = W // nh
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.rglru_conv, W), generator=generator, **f32)
    return {
        "w_x": dense_init(generator, D, W, dtype, device),
        "w_gate": dense_init(generator, D, W, dtype, device),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((W,), dtype=dtype, device=device),
        # block-diagonal gate weights: (heads, bw, bw)
        "w_a": _gate_init(generator, nh, bw, dtype, device),
        "b_a": torch.zeros((W,), **f32),
        "w_i": _gate_init(generator, nh, bw, dtype, device),
        "b_i": torch.zeros((W,), **f32),
        # the recurrence's decay starts in a stable range (a ~ 0.9..0.999)
        "lam": torch.linspace(0.3, 1.5, W, **f32),
        "w_out": dense_init(generator, W, D, dtype, device),
    }


def _block_diag(x, w):
    """x: (B, S, W) -> (B, S, W) through per-head (bw, bw) blocks."""
    nh, bw, _ = w.shape
    B, S, W = x.shape
    y = torch.einsum("bshw,hwv->bshv", x.reshape(B, S, nh, bw), w)
    return y.reshape(B, S, W)


def _combine(lhs, rhs):
    (al, bl), (ar, br) = lhs, rhs
    return al * ar, bl * ar + br


def _recurrence(a, bx):
    """h_t = a_t h_{t-1} + bx_t over axis 1, in ``jax.lax.associative_scan``'s
    pairing: combine adjacent pairs, scan the pairs, then fill in the even
    positions from the scanned odd ones."""
    n = a.shape[1]
    if n < 2:
        return bx
    return _scan((a, bx))[1]


def _scan(elems):
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine(tuple(e[:, 0:n - 1:2] for e in elems),
                       tuple(e[:, 1::2] for e in elems))
    odd = _scan(reduced)
    if n % 2 == 0:
        even = _combine(tuple(e[:, :-1] for e in odd),
                        tuple(e[:, 2::2] for e in elems))
    else:
        even = _combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1)
                 for e, r in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):
        o = ev.new_empty((ev.shape[0], n) + tuple(ev.shape[2:]))
        o[:, 0::2] = ev
        o[:, 1::2] = od
        out.append(o)
    return tuple(out)


def apply(p, x, *, cfg, run, positions=None, ftc=None, name="rglru",
          cache=None, mode="train"):
    """Returns (out, new_cache).  cache: {"h": (B, W), "conv": (B, K-1, W)}."""
    f32 = torch.float32
    gate = F.gelu(linear(x, p["w_gate"], ftc=ftc, name=f"{name}/w_gate"),
                  approximate="tanh")
    xb = linear(x, p["w_x"], ftc=ftc, name=f"{name}/w_x")
    W = xb.shape[-1]
    xb, gate = ac(xb, "dp", None, "tp"), ac(gate, "dp", None, "tp")
    conv_w, w_a, w_i = (ac(p["conv_w"], None, "tp"), ac(p["w_a"], "tp"),
                        ac(p["w_i"], "tp"))
    conv_b, b_a, b_i, lam = (ac(p[k], "tp")
                             for k in ("conv_b", "b_a", "b_i", "lam"))

    if mode == "decode":
        hist = torch.cat([cache["conv"], xb], dim=1)
        xc = (torch.einsum("bkc,kc->bc", hist, conv_w) + conv_b)[:, None, :]
        new_conv = hist[:, 1:]
    else:
        xc = _conv(xb, conv_w, conv_b)
        new_conv = xb[:, -(cfg.rglru_conv - 1):]

    r = torch.sigmoid(_block_diag(xc, w_a).to(f32) + b_a)
    i = torch.sigmoid(_block_diag(xc, w_i).to(f32) + b_i)
    xf = xc.to(f32)
    log_a = -C_FACTOR * softplus(lam)[None, None, :] * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9))
    bx = beta * (i * xf)

    if mode == "decode":
        h = a[:, 0] * cache["h"] + bx[:, 0]
        cache["h"].copy_(h)
        cache["conv"].copy_(new_conv)
        new_cache = cache
        hseq = h[:, None, :]
    else:
        hseq = _recurrence(a, bx)
        new_cache = ({"h": hseq[:, -1], "conv": new_conv.contiguous()}
                     if mode == "prefill" else cache)

    y = (hseq * gate.to(f32)).to(x.dtype)
    return linear(ag(y, -1, W), p["w_out"], ftc=ftc,
                  name=f"{name}/w_out"), new_cache
