"""Dense (G)LU feed-forward block.  Counterpart of ``repro.models.mlp``."""
from __future__ import annotations

from repro_torch.models.common import activation, dense_init, linear
from repro_torch.parallel.ctx import ac, ag


def init(generator, cfg, dtype, device):
    D, F = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(generator, D, F, dtype, device),
         "wo": dense_init(generator, F, D, dtype, device)}
    if cfg.glu:
        p["wg"] = dense_init(generator, D, F, dtype, device)
    return p


def apply(p, x, cfg, ftc=None, name="mlp"):
    """Under a mesh context the activation runs on this rank's block of
    d_ff (``ac``), gathered back whole for the protected ``wo``."""
    act = activation(cfg.act)
    h = linear(x, p["wi"], ftc=ftc, name=f"{name}/wi")
    F = h.shape[-1]
    h = ac(h, "dp", None, "tp")
    if cfg.glu:
        g = linear(x, p["wg"], ftc=ftc, name=f"{name}/wg")
        h = act(h) * ac(g, "dp", None, "tp")
    else:
        h = act(h)
    return linear(ag(h, -1, F), p["wo"], ftc=ftc, name=f"{name}/wo")
