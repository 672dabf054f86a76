"""Fault-aware training (FAT) of the MoE, Mamba2-SSD, RG-LRU,
encoder-decoder and vision-frontend families in the port against the
reference's jitted step, at their reduced sizes in float32: crt1 at BER
6e-3 mid-ramp (step counter 3 of a 6-step ramp), the port's ``fused``
backend (its plain version on the CPU) against the reference's, as
tests/test_torch_train.py holds danube's FAT step.

Held:
  * each protected site of the forward, by name (the list each family's
    test names: every projection ``linear`` protects, the MoE's float32
    router, seamless's cross-attention ``xk`` / ``xv`` and its unrolled
    encoder's sites), in the reference's call order: its int8 operand
    equals the reference's up to the first that differs, and there in
    one element, whose x / scale lies within TIE_ATOL of a .5 rounding tie;
  * the backward's recompute (``remat="block"``) calls every site again
    with the forward's operand, bit for bit;
  * the loss within LOSS_RTOL, the moments and parameters within FAT_RTOL
    of their largest, the BER and step counter equal.

recurrentgemma runs at 5 of its 8 reduced layers (one ``R,R,L`` period
and the ``R,R`` tail) and seamless at one encoder and one decoder layer:
the reference's jitted FAT step of the whole reduced configs compiles in
~2 minutes and ~1 minute on one CPU, and the cut keeps every kind of
layer of each.  Their cases live in tests/test_torch_family_fat_rg.py,
so that ``--dist loadfile`` gives them a worker of their own.
"""
import numpy as np
import pytest
import torch

import jax
from repro_torch.core import prng
from repro_torch.core import quantization as Q
from repro_torch.ft import api as tapi
from repro_torch.models import common
from test_torch_family_train import (LOSS_RTOL, close, port_step,
                                     reference, run_reference)

torch.set_num_threads(1)

# one int8 operand one step apart moves gradients by ~1% of the largest
# (tests/test_torch_train.py)
FAT_RTOL = 1e-2
TIE_ATOL = 1e-5
FAT = dict(policy="crt1", ft_ber=6e-3, fat_ramp=6)
FAT_COUNTER = 3

ATTN = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
GLU = ("mlp/wi", "mlp/wg", "mlp/wo")


def _sites(layers):
    """Site names of ``layers``: (prefix, the layer's site suffixes)."""
    return [f"{p}/{s}" for p, suffixes in layers for s in suffixes]


# each family's protected sites in the forward's order: the MoE's router is
# its block's one (its expert einsums are clean); the RG-LRU's gate, input
# and output projections; seamless's unrolled encoder and its
# cross-attention's xk / xv
RG = ("rglru/w_gate", "rglru/w_x", "rglru/w_out") + GLU
SITES = {
    "mamba2-2.7b": _sites([(f"l{i}", ("ssd/in_proj", "ssd/out_proj"))
                           for i in range(2)]),
    "qwen3-moe-235b-a22b": _sites([(f"l{i}", ATTN + ("moe/router",))
                                   for i in range(2)]),
    "paligemma-3b": _sites([(f"l{i}", ATTN + GLU) for i in range(2)]),
    "recurrentgemma-9b": _sites([("l0", RG), ("l1", RG), ("l2", ATTN + GLU),
                                 ("l3", RG), ("l4", RG)]),
    "seamless-m4t-medium": _sites([
        ("enc0", ATTN + ("mlp/wi", "mlp/wo")),
        ("l0", ATTN + ("xk", "xv", "xattn/wq", "xattn/wo", "mlp/wi",
                       "mlp/wo"))]),
}
CUTS = {"recurrentgemma-9b": (("n_layers", 5),),
        "seamless-m4t-medium": (("n_layers", 1), ("n_enc_layers", 1))}
# the first site whose int8 operand differs, at a .5 tie, where one does
# (the jitted reference and the port round x / scale on either side)
TIES = {"mamba2-2.7b": "l1/ssd/out_proj",
        "seamless-m4t-medium": "l0/xattn/wo"}
HERE = ("mamba2-2.7b", "qwen3-moe-235b-a22b", "paligemma-3b")


def _site_int8(x):
    """(int8 operand, x / scale) of a site's float32 input."""
    xt = torch.from_numpy(np.array(x))
    q, scale = Q.quantize(xt)
    return q.numpy(), (xt / scale).numpy()


def hold_fat(arch, cut, sites, monkeypatch):
    """One FAT step of ``arch`` (cut to ``cut``) in both packages, held as
    the module docstring says; ``sites`` the forward's site names."""
    jm, state, batch = reference(arch, cut)
    wxs = []
    want, wmet = run_reference(jm, state, batch, FAT_COUNTER, record=wxs,
                               ft_key=jax.random.PRNGKey(17), **FAT)
    names, xs = [], []
    real_key, real_pl = common.FTCtx.site_key, tapi.protect_linear

    def site_key(self, name):
        names.append(name)
        return real_key(self, name)

    def recorded(key, x, *a, **kw):
        xs.append(x.detach().numpy().copy())
        return real_pl(key, x, *a, **kw)
    monkeypatch.setattr(common.FTCtx, "site_key", site_key)
    monkeypatch.setattr(tapi, "protect_linear", recorded)
    got, gmet = port_step(arch, state, batch, FAT_COUNTER, cut,
                          ft_key=prng.PRNGKey(17), ft_backend="fused", **FAT)
    n = len(sites)
    assert names[:n] == sites and len(wxs) == n
    assert sorted(names[n:]) == sorted(sites) and len(xs) == 2 * n
    fwd = dict(zip(names[:n], xs[:n]))
    for name, x2 in zip(names[n:], xs[n:]):      # the recompute
        np.testing.assert_array_equal(x2, fwd[name], name)
    first = None
    for name, w, x in zip(sites, wxs, xs[:n]):
        (qw, rw), (qx, _) = _site_int8(w), _site_int8(x)
        apart = qw != qx
        if first is None and apart.any():
            first = name
            assert apart.sum() == 1, name
            assert (np.abs(np.abs(rw[apart]) % 1 - 0.5) < TIE_ATOL).all(), \
                name
    np.testing.assert_allclose(gmet["loss"].item(), float(wmet["loss"]),
                               rtol=LOSS_RTOL)
    for part in ("m", "v", "params"):
        close(want[part], got[part], FAT_RTOL, part)
    assert int(got["step"]) == int(want["step"]) == FAT_COUNTER + 1
    assert gmet["fat_ber"].item() == float(wmet["fat_ber"])
    assert gmet["fat_ber"].item() == np.float32(FAT["ft_ber"]) / 2
    clean, cmet = run_reference(jm, state, batch, FAT_COUNTER)
    assert abs(float(wmet["loss"]) - float(cmet["loss"])) \
        > 100 * LOSS_RTOL * float(cmet["loss"])    # the faults show
    return first


def check_family(arch, monkeypatch):
    first = hold_fat(arch, CUTS.get(arch, ()), SITES[arch], monkeypatch)
    assert first in (None, TIES.get(arch)), first


@pytest.mark.parametrize("arch", HERE)
def test_fat_step_equals_reference(arch, monkeypatch):
    check_family(arch, monkeypatch)
