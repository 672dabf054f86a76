"""``protect_linear``: the single fault-tolerant linear entry point.

Counterpart of ``repro.ft.api``.  Three backends compute the same FlexHyCA
semantics:

  * ``backend="reference"``: the functional model (``_protect_reference``),
    plain torch ops, the yardstick of the other;
  * ``backend="fused"``: the fused kernel (``repro_torch.kernels.
    fused_decode``): the same key schedule and fault draws, packed into int32
    flip words and consumed by one hand-written CUDA kernel on the GPU.  It
    equals ``reference`` bitwise for every registry policy, global or (M, 2)
    per-row keys, weight faults included, ``dyn`` overrides supported;
  * ``backend="pallas"``: the protected-matmul kernel (``repro_torch.kernels.
    protected_mm``), one hand-written CUDA kernel on the GPU: int8 GEMM,
    24-bit saturation, a static truncation LSB ``t`` (per-layer deployment
    state, calibrated from the inputs when not given) and selective bit
    protection on two uint32 plane streams of its own
    (``fault_inject.ops.random_planes``).  It models ECC-protected weight
    SRAM, so ``policy.weight_faults`` does not apply; it takes one key and no
    ``dyn``.  Its draws differ from the other two backends', so it equals
    them only at BER 0; it equals the reference package's pallas backend
    bitwise.

``protect_linear_ste`` is the fault-aware-training (FAT) entry point: the
forward is ``protect_linear``'s output unchanged, the backward the clean
float32 matmul's (the straight-through estimator, a
``torch.autograd.Function``).
"""
from __future__ import annotations

import torch

from repro_torch.core import faults, prng
from repro_torch.core import quantization as Q
from repro_torch.ft.policy import ProtectionPolicy
from repro_torch.kernels.fused_decode import ops as fused_ops
from repro_torch.kernels.protected_mm import ops as pm_ops
from repro_torch.kernels.protected_mm.kernel import protected_mm

BACKENDS = ("reference", "fused", "pallas")


def calibrate_t(x, w, q_scale: int = 0) -> int:
    """Pick a layer's truncation LSB from calibration data: deployment state
    for the pallas backend, whose kernel takes ``t`` statically."""
    return pm_ops.calibrate_t(x, w, q_scale=q_scale)


def protect_linear(key, x: torch.Tensor, w: torch.Tensor,
                   policy: ProtectionPolicy, important=None, *,
                   layer_protected: bool = True, backend: str = "reference",
                   t: int | None = None, dyn=None) -> torch.Tensor:
    """Fault-tolerant linear: float in/out, faulty quantized DLA inside.

    Args:
      key: one key ``(2,)``, or an (M, 2) batch of keys, one per row of the
        flattened ``x``, for per-row fault streams and quantization scales.
      x: (..., K) float32 activations.  w: (K, N) float32 weights.
      policy: a :class:`ProtectionPolicy` (``repro_torch.ft.get_policy``).
      important: (N,) bool mask of important output channels; consumed only
        by recompute policies.
      layer_protected: for whole-layer-TMR policies, whether this layer is in
        the protected set.
      backend: "reference" | "fused" | "pallas".
      t: the pallas backend's truncation LSB; calibrated from ``x`` and
        ``w`` (a host sync) when None.  The other backends ignore it.
      dyn: optional overrides of ``ib_th`` / ``nb_th`` / ``q_scale`` (ints
        or int tensors on the device).
    Returns (..., N) float32.
    """
    if backend == "reference":
        return _protect_reference(key, x, w, policy, important,
                                  layer_protected, dyn)
    if backend == "fused":
        return fused_ops.fused_protect_linear(
            key, x, w, policy, important, layer_protected=layer_protected,
            dyn=dyn)
    if getattr(key, "ndim", 1) == 2:
        raise ValueError("per-row key batches are only supported by "
                         "backend='reference' or backend='fused'")
    if dyn:
        raise ValueError("dyn knob overrides are only supported by "
                         "backend='reference' or backend='fused' (the "
                         "pallas kernel takes its protection knobs "
                         "statically)")
    if backend == "pallas":
        return _protect_pallas(key, x, w, policy, important,
                               layer_protected=layer_protected, t=t)
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


class _ProtectSTE(torch.autograd.Function):
    """Forward: ``protect_linear`` on the operands, its output untouched.
    Backward: the cotangents of the clean float32 ``x @ w``, cast back to
    the operands' dtypes (the reference's ``_ste_tie``)."""

    @staticmethod
    def forward(ctx, x, w, key, policy, important, kw):
        ctx.save_for_backward(x, w)
        return protect_linear(key, x, w, policy, important, **kw)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.to(torch.float32).reshape(-1, w.shape[1])
        x2 = x.to(torch.float32).reshape(-1, w.shape[0])
        gx = (g2 @ w.to(torch.float32).T).reshape(x.shape).to(x.dtype)
        gw = (x2.T @ g2).to(w.dtype)
        return gx, gw, None, None, None, None


def protect_linear_ste(key, x: torch.Tensor, w: torch.Tensor,
                       policy: ProtectionPolicy, important=None,
                       **kw) -> torch.Tensor:
    """:func:`protect_linear` with a straight-through gradient rule.

    The forward value is the :func:`protect_linear` output bit for bit (the
    training loss sees exactly the faulty datapath the deployment runs);
    the backward returns the cotangents of the clean float ``x @ w``, as if
    the quantize/flip/truncate chain were the identity.  ``kw`` is
    forwarded verbatim (``layer_protected`` / ``backend`` / ``t`` /
    ``dyn``)."""
    return _ProtectSTE.apply(x, w, key, policy, important, kw)


def _protect_reference(key, x, w, policy: ProtectionPolicy, important,
                       layer_protected: bool, dyn=None):
    """The reference backend's datapath, structure-dispatched on the policy.

    An (M, 2) key batch switches to per-row mode: each row gets its own
    activation scale, truncation LSB and fault draws, and with
    ``policy.weight_faults`` its own faulty view of the shared weights.
    """
    dev = x.device
    key = prng.as_key(key, dev)
    orig_shape = x.shape
    x2 = x.reshape(-1, orig_shape[-1])
    per_row = key.dim() == 2
    kw, ka, kd = fused_ops.key_schedule(key)
    n = w.shape[1]
    ib_th, nb_th, q_scale = fused_ops.knobs(policy, dyn, dev)
    ber = fused_ops.ber_scalar(policy.ber, dev)

    xq, sx = Q.quantize(x2, axis=1 if per_row else None)
    wq, sw = Q.quantize(w)
    if policy.weight_faults and per_row:
        # each row's private faulty-weight view: (M, K, N) flip words
        wfl = faults.flip_word(kw, wq.shape, ber, Q.OUT_BITS)
        uw = (wq.unsqueeze(0) & ((1 << Q.OUT_BITS) - 1)) ^ wfl
        wq_f = torch.where((uw & (1 << (Q.OUT_BITS - 1))) != 0,
                           uw - (1 << Q.OUT_BITS), uw)
        acc = Q.int_matmul(xq, wq_f)
    else:
        wq_f = (faults.inject_weight_faults(kw, wq, ber)
                if policy.weight_faults else wq)
        acc = Q.int_matmul(xq, wq_f)
    acc = Q.saturate(acc)
    absmax = (acc.abs().amax(dim=1, keepdim=True) if per_row
              else acc.abs().amax())
    t = Q.choose_trunc_lsb(absmax, q_scale=q_scale)
    yq = Q.truncate_acc(acc, t)

    # circuit layer: per-channel protected high bits
    protect = fused_ops.output_protection(policy, important, ib_th, nb_th,
                                          layer_protected, n, dev)
    yq_f = faults.inject_output_faults(ka, yq, ber, protect_top=protect)

    if policy.arch.recompute and important is not None:
        # architecture layer: the DPPU recomputes important channels from
        # clean weights with IB_TH-protected MACs and overrides them
        acc_d = Q.saturate(Q.int_matmul(xq, wq))
        yq_d = Q.truncate_acc(acc_d, t)
        yq_d = faults.inject_output_faults(
            kd, yq_d, ber, protect_top=torch.broadcast_to(ib_th, (n,)))
        yq_f = torch.where(important.reshape(1, -1), yq_d, yq_f)

    y = fused_ops.rescale(yq_f, sx, sw, t)
    return y.reshape(*orig_shape[:-1], n)


def _protect_pallas(key, x, w, policy: ProtectionPolicy, important, *,
                    layer_protected: bool, t: int | None, block: int = 128):
    """The pallas backend: quantize, draw both plane streams over the output
    padded to ``block`` multiples (the reference pads every operand to its
    kernel's tiles and draws there: the plane shape is part of the fault
    stream), hand the kernel their (M, N) corner, rescale.  The kernel needs
    no padding of its own."""
    dev = x.device
    key = prng.as_key(key, dev)
    orig_shape = x.shape
    x2 = x.reshape(-1, orig_shape[-1]).to(torch.float32)
    w = w.to(torch.float32)
    m, n = x2.shape[0], w.shape[1]

    xq, sx = Q.quantize(x2)
    wq, sw = Q.quantize(w)
    if t is None:
        acc = Q.saturate(Q.int_matmul(xq, wq))
        t = int(Q.choose_trunc_lsb(acc.abs().amax(),
                                   q_scale=policy.algorithm.q_scale))

    circ = policy.circuit
    if policy.arch.whole_layer_tmr:
        ib = nb = Q.OUT_BITS if layer_protected else 0
    else:
        ib, nb = circ.ib_th, circ.nb_th
    if important is None or not policy.uses_importance:
        imp = torch.zeros((n,), dtype=torch.int32, device=dev)
    else:
        imp = important.to(torch.int32)

    padded = (-(-m // block) * block, -(-n // block) * block)
    rnd_o, rnd_i = pm_ops.plane_streams(key, padded, m, n)
    yq = protected_mm(xq.to(torch.int8), wq.to(torch.int8), rnd_o, rnd_i, imp,
                      t=t, ber=float(policy.ber), ib=ib, nb=nb)
    y = yq.to(torch.float32) * (sx * sw * (2.0 ** t))
    return y.reshape(*orig_shape[:-1], n)
