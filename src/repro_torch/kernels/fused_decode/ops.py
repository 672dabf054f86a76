"""``fused_protect_linear``: the full ``protect_linear`` semantics on the
fused kernel (``backend="fused"``).

Counterpart of ``repro.kernels.fused_decode.ops``.  The split that keeps it
bitwise equal to the reference backend:

  * here: quantization (the only float<->int boundaries), the policy's key
    schedule (the same splits and draw shapes as
    ``ft.api._protect_reference``) and the packing of every fault draw into
    int32 flip words (``repro_torch.core.faults.flip_word``);
  * in the kernel: integer math on those operands (matmul, saturate,
    truncation LSB, XOR, select).

No padding is needed: the CUDA kernel masks ragged tiles itself.  ``q_scale``
stays a device tensor, so a ``dyn`` override costs no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.core import faults, prng
from repro_torch.core import quantization as Q
from repro_torch.device import scalar
from repro_torch.kernels.fused_decode.kernel import fused_decode


def ber_scalar(ber, device) -> torch.Tensor:
    """The policy's BER as the reference's jitted datapath sees it: a 0-d
    float32 value (the policy pytree's one traced leaf)."""
    return scalar(ber, torch.float32, device)


def key_schedule(key: torch.Tensor):
    """(kw, ka, kd) = split(key, 3), per row for an (M, 2) key batch."""
    ks = prng.split(key, 3)
    return ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]


def knobs(policy, dyn, device):
    """(ib_th, nb_th, q_scale), each replaced by its ``dyn`` override."""
    dyn = dyn or {}
    circ = policy.circuit

    def val(name, default):
        return scalar(dyn.get(name, default), torch.int32, device)
    return (val("ib_th", circ.ib_th), val("nb_th", circ.nb_th),
            val("q_scale", policy.algorithm.q_scale))


def output_protection(policy, important, ib_th, nb_th, layer_protected,
                      n, device):
    """Per-channel count of protected high output bits."""
    imp = (torch.zeros((n,), dtype=torch.bool, device=device)
           if important is None else important)
    protect = torch.where(imp, ib_th, nb_th).to(torch.int32)
    if policy.arch.whole_layer_tmr and layer_protected:
        protect = torch.full((n,), Q.OUT_BITS, dtype=torch.int32,
                             device=device)
    return protect


def rescale(yq, sx, sw, t):
    """float32 output in the reference's expression order.  ``2**t`` is
    formed exactly from an integer shift (the reference's ``2.0 ** t`` is
    exact; a device ``pow``/``exp2`` need not be)."""
    scale = sx * sw * (torch.ones_like(t) << t).to(torch.float32)
    return yq.to(torch.float32) * scale


def fused_protect_linear(key, x, w, policy, important=None, *,
                         layer_protected: bool = True, dyn=None):
    """Fault-tolerant linear on the fused kernel: float in/out.

    Takes what ``protect_linear`` takes: one key or an (M, 2) per-row key
    batch, every registry policy (weight faults included, shared or per
    row), an ``important`` mask, ``layer_protected`` and ``dyn`` overrides.
    """
    dev = x.device
    key = prng.as_key(key, dev)
    orig_shape = x.shape
    x2 = x.reshape(-1, orig_shape[-1])
    m, n = x2.shape[0], w.shape[1]
    per_row = key.dim() == 2
    kw, ka, kd = key_schedule(key)
    ib_th, nb_th, q_scale = knobs(policy, dyn, dev)
    ber = ber_scalar(policy.ber, dev)

    xq, sx = Q.quantize(x2, axis=1 if per_row else None)
    wq, sw = Q.quantize(w)

    # weight-fault flip words: the same draws as inject_weight_faults
    wq_k, wq_clean, wflips, perrow_wf = wq, None, None, False
    if policy.weight_faults:
        if per_row:
            wflips = faults.flip_word(kw, wq.shape, ber, Q.OUT_BITS)
            perrow_wf = True
        else:
            wq_k = faults.inject_weight_faults(kw, wq, ber)
            wq_clean = wq

    # output flip words, protection folded into the draw's residual rates
    protect = output_protection(policy, important, ib_th, nb_th,
                                layer_protected, n, dev)
    pmask = faults.protect_mask(protect, Q.OUT_BITS)
    oshape = (n,) if per_row else (m, n)
    oflips = faults.flip_word(ka, oshape, ber, Q.OUT_BITS, pmask)

    # DPPU recompute flip words
    kwargs = {}
    dppu_src = "none"
    if policy.arch.recompute and important is not None:
        dmask = faults.protect_mask(torch.broadcast_to(ib_th, (n,)),
                                    Q.OUT_BITS)
        kwargs["dflips"] = faults.flip_word(kd, oshape, ber, Q.OUT_BITS,
                                            dmask)
        kwargs["imp"] = important.to(torch.int32)
        if perrow_wf:
            dppu_src = "w"          # wq operand is clean; flips are separate
        elif wq_clean is not None:
            dppu_src = "wcl"        # wq operand pre-faulted; recompute clean
            kwargs["wq_clean"] = wq_clean.to(torch.int8)
        else:
            dppu_src = "reuse"      # no weight faults: clean acc == acc
    if perrow_wf:
        kwargs["wflips"] = wflips

    yq8, tcol = fused_decode(
        xq.to(torch.int8), wq_k.to(torch.int8).contiguous(),
        oflips.contiguous(), q_scale.reshape(1), per_row=per_row,
        dppu_src=dppu_src, perrow_wf=perrow_wf, **kwargs)
    t = tcol if per_row else tcol[0, 0]
    y = rescale(yq8.to(torch.int32), sx, sw, t)
    return y.reshape(*orig_shape[:-1], n)
