"""Mamba2 SSD (state-space duality) block.  Counterpart of
``repro.models.ssm``.

Train and prefill run the chunked SSD: a quadratic term within each chunk
and the state carried across chunks, one chunk at a time (the reference's
``lax.scan``), so the largest live buffer is O(B * H * chunk^2).  A prompt
that is not a multiple of the chunk is padded with ``dt = 0`` steps, which
neither decay nor write the state.  Decode is an O(1) state update, written
into the cache in place (the decode step of a CUDA graph owns its caches).
The state is float32 ``(B, H, P, N)``; the conv history holds the last
``conv_width - 1`` inputs in the compute dtype.  Protected sites:
``{name}/in_proj`` and ``{name}/out_proj``.

Under a mesh context the block computes whole on every rank; its caches
hold this rank's block of the state's heads and of the conv channels (the
reference's cache layout), gathered whole before a decode step and cut
again after it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, linear, rms_norm
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.ctx import ac, ag


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


def init(generator, cfg, dtype, device):
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H = dims(cfg)
    conv_ch = d_inner + 2 * s.d_state
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((s.conv_width, conv_ch), generator=generator, **f32)
    return {
        # order: [z, x, B, C, dt]
        "in_proj": dense_init(generator, D, 2 * d_inner + 2 * s.d_state + H,
                              dtype, device),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": torch.zeros((d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, d_inner, D, dtype, device),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _split(cfg, zxbcdt):
    s = cfg.ssm
    d_inner, H = dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, s.d_state, s.d_state, H],
                       dim=-1)


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)), with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x, dt, A, Bm, Cm, chunk):
    """SSD over whole sequences.  x: (B, S, H, P), dt: (B, S, H), A: (H,),
    Bm/Cm: (B, S, N); S a multiple of ``chunk``.  Returns (y (B, S, H, P),
    the final state (B, H, P, N)), both float32."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    f32 = torch.float32
    xc = x.reshape(Bsz, nc, chunk, H, Pd).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(f32)
    seg = torch.cumsum(dtc * A, dim=2).to(f32)          # (B, nc, L, H)
    dtc = dtc.to(f32)

    iq = torch.arange(chunk, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    inf = torch.full((), float("inf"), device=x.device)
    state = torch.zeros((Bsz, H, Pd, N), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xi, dti, Bi, Ci, segi = (xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c],
                                 seg[:, c])
        # in-chunk quadratic term; mask before exp so masked entries never
        # overflow
        Lmat = segi[:, :, None, :] - segi[:, None, :, :]   # (B, Lq, Lk, H)
        dec = torch.exp(-torch.where(causal, Lmat, inf))
        scores = torch.einsum("bqn,bkn->bqk", Ci, Bi)[..., None] * dec
        y_intra = torch.einsum("bqkh,bkh,bkhp->bqhp", scores, dti, xi)
        # the carried state's contribution
        y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", Ci, state,
                               torch.exp(-segi))
        seg_last = segi[:, -1:, :]                         # (B, 1, H)
        w = torch.exp(-(seg_last - segi)) * dti            # (B, L, H)
        state = (state * torch.exp(-seg_last)[:, 0, :, None, None]
                 + torch.einsum("bkh,bkn,bkhp->bhpn", w, Bi, xi))
        ys.append(y_intra + y_inter)
    return torch.stack(ys, 1).reshape(Bsz, S, H, Pd), state


def apply(p, x, *, cfg, run, positions=None, ftc=None, name="ssd",
          cache=None, mode="train"):
    """Mamba2 mixer.  Returns (out, new_cache)."""
    s = cfg.ssm
    d_inner, H = dims(cfg)
    B = x.shape[0]
    f32 = torch.float32
    zxbcdt = linear(x, p["in_proj"], ftc=ftc, name=f"{name}/in_proj")
    z, xi, Bm, Cm, dt = _split(cfg, zxbcdt)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)

    local = cache
    if mode == "decode" and pctx.get_ctx() is not None:
        cache = {"state": ag(cache["state"], 1, H),
                 "conv": ag(cache["conv"], 2, conv_in.shape[-1])}
    if mode == "decode":
        hist = torch.cat([cache["conv"], conv_in], dim=1)   # (B, K, C)
        conv_out = (torch.einsum("bkc,kc->bc", hist, p["conv_w"])
                    + p["conv_b"])[:, None, :]
        new_conv = hist[:, 1:]
    else:
        conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
        new_conv = conv_in[:, -(s.conv_width - 1):]
    conv_out = F.silu(conv_out)
    xi, Bm, Cm = torch.split(conv_out, [d_inner, s.d_state, s.d_state],
                             dim=-1)

    xh = xi.reshape(B, -1, H, s.head_dim)
    A = torch.exp(p["A_log"])
    dt_s = softplus(dt.to(f32) + p["dt_bias"])

    if mode == "decode":
        dA = torch.exp(-dt_s[:, 0, :] * A)                  # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt_s[:, 0, :],
                           Bm[:, 0].to(f32), xh[:, 0].to(f32))
        state = cache["state"] * dA[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(f32), state)
        y = y.reshape(B, 1, H, s.head_dim)
        local["state"].copy_(ac(state, "dp", "tp", None, None))
        local["conv"].copy_(ac(new_conv, "dp", None, "tp"))
        new_cache = local
    else:
        S_in = xh.shape[1]
        rem = S_in % s.chunk
        if rem:
            # pad to a chunk multiple with dt = 0 steps; their outputs are
            # dropped
            pad = s.chunk - rem
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
            dt_s = F.pad(dt_s, (0, 0, 0, pad))
        else:
            xh_p = xh
        y, state = ssd_chunked(xh_p, dt_s, A, Bm, Cm, s.chunk)
        y = y[:, :S_in]
        new_cache = ({"state": ac(state, "dp", "tp", None, None),
                      "conv": ac(new_conv, "dp", None, "tp").contiguous()}
                     if mode == "prefill" else cache)

    y = y + xh.to(f32) * p["D"][None, None, :, None]
    y = y.reshape(B, -1, d_inner)
    y = y * F.silu(z.to(f32))
    y = rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    return linear(y, p["out_proj"], ftc=ftc,
                  name=f"{name}/out_proj"), new_cache
