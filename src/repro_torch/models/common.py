"""Shared model components: norms, rotary embeddings, inits, activations, and
the fault-tolerant ``linear`` every projection goes through.

Counterpart of ``repro.models.common``.  Shapes and layouts are the
reference's ((..., S, H, D) for heads; (d_in, d_out) weights), so the tests
compare like with like.
"""
from __future__ import annotations

import zlib

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.parallel import ctx as pctx


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- init -----
def _trunc_normal(shape, std, dtype, device, generator):
    if torch.device(device).type == "meta":   # the shape alone: no draws
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def dense_init(generator, d_in: int, d_out: int, dtype, device):
    """Truncated normal in [-2, 2] standard deviations, std 1/sqrt(d_in)
    (the reference's distribution; the draws themselves differ)."""
    return _trunc_normal((d_in, d_out), d_in ** -0.5, dtype, device,
                         generator)


def embed_init(generator, vocab: int, d: int, dtype, device):
    return _trunc_normal((vocab, d), d ** -0.5, dtype, device, generator)


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    # statistics in float32, data flow in the compute dtype, as the reference
    xf = x.to(torch.float32)
    rs = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return x * rs.to(x.dtype) * (1.0 + scale).to(x.dtype)


# ---------------------------------------------------------------- rope -----
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary position embedding.  x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.unsqueeze(-1).to(torch.float32) * freq
    cos = torch.cos(ang).unsqueeze(-2)          # broadcast over heads
    sin = torch.sin(ang).unsqueeze(-2)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ activations --
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * logistic(x), the logistic as XLA expands it,
    1 / (1 + exp(-x)), each op rounded to the operands' dtype (in bf16 the
    fused ``F.silu`` parts from it by several ulps)."""
    return x * torch.reciprocal(torch.exp(-x) + 1)


def activation(name: str):
    return {"silu": silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ------------------------------------------------------------ ft routing ---
class EmuCtx:
    """Structural-cost emulation of FlexHyCA protection (no faults, no
    keys): the naive port of the DPPU as a second GEMM pass over the
    important channels (``"two_pass"``) against protection in the same
    tile pass (``"fused"``, no extra GEMM).  Both give the plain matmul's
    values; they differ in cost only."""

    def __init__(self, mode: str, s_th: float = 0.05):
        if mode not in ("two_pass", "fused"):
            raise ValueError(f"EmuCtx mode {mode!r}; expected 'two_pass' "
                             "or 'fused'")
        self.mode = mode
        self.s_th = s_th


class FTCtx:
    """Per-forward fault-tolerance context: a protection policy (or registry
    name), per-site importance masks, per-site keys and, for the pallas
    backend, per-site truncation LSBs.

    ``key`` is one key ``(2,)`` (one fault stream for the whole forward) or a
    ``(B, 2)`` batch, one independent stream per batch row.  Site ``name``
    draws from ``fold_in(key, crc32(name))``: site names are part of the
    fault-key contract.  ``backend`` is "reference", "fused" or "pallas".
    ``t`` is one int for every site or a ``{site: int}`` table, the pallas
    backend's truncation LSBs: deployment state, so a pallas site without
    one raises, as under the reference's jit (where its Engine runs every
    step); only a direct ``protect_linear`` call calibrates.
    ``protected_layers`` is the set of layer names (a site's prefix before
    ``/``) that whole-layer-TMR policies protect, None for all.  ``dyn``
    optionally overrides the policy's numeric knobs (``{"ib_th", "nb_th",
    "q_scale"}``, ints or int tensors), as the DSE's batched oracle does.
    ``ste=True`` routes every site through ``protect_linear_ste`` (forward
    the faulty datapath bit for bit, backward the clean matmul's
    gradients): fault-aware training.
    """

    def __init__(self, ft, key, masks=None, protected_layers=None,
                 backend: str = "reference", t=None, dyn=None,
                 ste: bool = False):
        from repro_torch.ft import as_policy
        self.ft = as_policy(ft)
        self.key = key
        self.masks = masks or {}
        self.protected_layers = protected_layers
        self.backend = backend
        self.t = t
        self.dyn = dyn
        self.ste = ste

    def site_key(self, name: str) -> torch.Tensor:
        return prng.fold_in(self.key, zlib.crc32(name.encode()))

    def site_t(self, name: str):
        t = self.t.get(name) if isinstance(self.t, dict) else self.t
        if t is None and self.backend == "pallas":
            raise ValueError(
                f"backend='pallas' site {name!r} has no pre-calibrated "
                "truncation LSB: pass FTCtx(t=...) or Engine(..., ft_t=...) "
                "(one int or a {site: int} table; see "
                "repro_torch.ft.calibrate_t) or use another backend")
        return t


def linear(x: torch.Tensor, w: torch.Tensor, b=None, *,
           ftc: FTCtx | EmuCtx | None = None, name: str = "") -> torch.Tensor:
    """Every projection routes through here: the clean matmul, its cost
    emulation (``EmuCtx``), or, under a policy, ``protect_linear`` (or
    ``protect_linear_ste``) on float32 operands with the result cast back
    to the compute dtype (the reference's order).

    Under a mesh context whose batch rows are split over the dp axes, a
    protected projection under one key takes the whole batch's rows
    (``gather_rows``) and keeps this rank's rows of the result: its
    activation scale, truncation LSB and fault draws span the whole
    ``(M, K)`` input, so the rank computes what the meshless call
    computes.  Per-row keys make all three row-local: those rows stay
    split."""
    if isinstance(ftc, EmuCtx):
        w2 = w.reshape(w.shape[0], -1)
        y = x @ w2
        if ftc.mode == "two_pass":
            # the DPPU as a separate pass: recompute the important channels
            # from a second weight read and vote
            k = max(int(ftc.s_th * w2.shape[1]), 1)
            y_sel = x @ w2[:, :k]
            y = torch.cat([((y[..., :k] + y_sel) * 0.5).to(y.dtype),
                           y[..., k:]], dim=-1)
        y = y.reshape(*x.shape[:-1], *w.shape[1:])
    elif ftc is None or ftc.ft is None:
        y = x @ w.reshape(w.shape[0], -1)
        y = y.reshape(*x.shape[:-1], *w.shape[1:])
    else:
        from repro_torch.ft import protect_linear, protect_linear_ste
        pl = protect_linear_ste if ftc.ste else protect_linear
        w2 = w.reshape(w.shape[0], -1).to(torch.float32)
        imp = ftc.masks.get(name)
        prot = (ftc.protected_layers is None
                or name.split("/")[0] in ftc.protected_layers)
        sk = ftc.site_key(name)
        whole = sk.dim() == 1
        if whole:
            x = pctx.gather_rows(x)
        if sk.dim() == 2:
            # per-row streams: x flattens to (B*S, K) row-major, so each
            # row key repeats over that row's S positions
            reps = max(x.numel() // x.shape[-1], 1) // sk.shape[0]
            if reps != 1:
                sk = torch.repeat_interleave(sk, reps, dim=0)
        y = pl(sk, x.to(torch.float32).reshape(-1, w.shape[0]), w2, ftc.ft,
               important=None if imp is None else torch.as_tensor(
                   imp, device=x.device),
               layer_protected=prot, backend=ftc.backend, t=ftc.site_t(name),
               dyn=ftc.dyn)
        y = y.reshape(*x.shape[:-1], *w.shape[1:]).to(x.dtype)
        if whole:
            y = pctx.local_rows(y)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def tag(probe, name: str, x: torch.Tensor) -> torch.Tensor:
    """Neuron-importance tap site (Algorithm 1)."""
    return x if probe is None else probe.tag(name, x)
