"""Train, prefill and decode step builders.

Counterpart of ``repro.train.train_step`` on one device: the step runs
eagerly (the reference jits it), so ``make_train_step`` returns the step
function itself.  A train state is ``{"params", "m", "v", "step"}``, the
step counter a 0-d int32 tensor on the device.

Fault-aware training (FAT): ``policy=`` threads an ``FTCtx(ste=True)``
through the forward, so the network trains through the faulty quantized
datapath (forward bit for bit, backward the clean straight-through
gradients).  The fault keys of a step are folded from one root key by the
step counter, and under gradient accumulation by the microbatch index:
``fold_stream(ft_key, step, i)``.  The BER ramp is a float32 function of
the same counter.  As the counter lives in the state, a run resumed from a
checkpoint continues the exact fault stream.  Meshes (``mesh=``) wait for
the port's parallel layer.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.faults import fold_stream
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.tree import leaves, tree_map

_NO_MESH = ("mesh= is not ported yet: the sharded train step comes with "
            "the parallel layer (ROADMAP.md, queue A, item 6)")


def make_loss_fn(model):
    def loss_fn(params, batch, ftc=None):
        return model.loss(params, batch, ftc=ftc)
    return loss_fn


def fat_ber_at(target_ber: float, ramp_steps: int, step) -> torch.Tensor:
    """Linear BER warm-up 0 -> ``target_ber`` over ``ramp_steps`` updates,
    a 0-d float32 tensor (on the device of ``step``, where it is a
    tensor), computed in float32 as the reference's traced ramp."""
    step = torch.as_tensor(step).to(torch.float32)
    frac = (torch.clamp(step / float(ramp_steps), 0.0, 1.0) if ramp_steps > 0
            else torch.ones((), device=step.device))
    return torch.full((), target_ber, dtype=torch.float32,
                      device=step.device) * frac


def _grads(loss_fn, params, batch, ftc):
    """(loss, grads) of one (micro)batch; grads in the parameters' dtypes."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    flat = leaves(p)
    loss, _ = loss_fn(p, batch, ftc)
    by_leaf = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    return loss.detach(), tree_map(lambda t: by_leaf[id(t)], p)


def _accumulate(loss_fn, params, batch, n_accum: int, ftc_at=None):
    """Mean (loss, grads) over ``n_accum`` microbatches (rows split in
    order), gradients accumulated in the parameters' dtypes.  ``ftc_at(i)``
    builds microbatch ``i``'s fault context, so each draws from its own
    fold of the step key."""
    if n_accum <= 1:
        return _grads(loss_fn, params, batch,
                      None if ftc_at is None else ftc_at(0))

    def slice_mb(x, i):
        b = x.shape[0]
        if b % n_accum:
            raise ValueError(f"batch {b} does not split into {n_accum} "
                             "microbatches")
        return x.reshape(n_accum, b // n_accum, *x.shape[1:])[i]

    loss_acc = torch.zeros((), device=leaves(params)[0].device)
    grads_acc = tree_map(torch.zeros_like, params)
    for i in range(n_accum):
        mb = {k: slice_mb(v, i) for k, v in batch.items()}
        loss, grads = _grads(loss_fn, params, mb,
                             None if ftc_at is None else ftc_at(i))
        grads_acc = tree_map(lambda a, g: a + g.to(a.dtype), grads_acc,
                             grads)
        loss_acc = loss_acc + loss
    inv = 1.0 / n_accum
    return loss_acc * inv, tree_map(lambda g: g * inv, grads_acc)


def init_state(model, generator: torch.Generator, opt_cfg: AdamWConfig,
               device=None) -> dict:
    """Fresh parameters from ``generator`` (on ``device``) and zero
    optimizer state."""
    params = model.init(generator, device=device)
    return {"params": params, **init_opt_state(params, opt_cfg)}


def make_train_step(model, opt_cfg: AdamWConfig, mesh=None, donate=True,
                    policy=None, ft_ber: float | None = None, ft_key=None,
                    fat_ramp: int = 0, ft_backend: str = "reference",
                    masks=None):
    """``step(state, batch) -> (state, metrics)``: one optimizer update over
    ``model.run.grad_accum`` microbatches.  With ``donate`` (the default,
    as the reference's jitted step donates its state) the parameters and
    moments are updated in place, so the input state is consumed; with
    ``donate=False`` a new state is returned and the old one stays as it
    was.

    FAT arguments (``policy=None`` is the clean step):
      policy: a ProtectionPolicy or registry name, the faults the network
        trains through; its BER is replaced by the ramp's.
      ft_ber: target training BER (default ``policy.ber``).
      ft_key: root key of the fault stream (default
        ``PRNGKey(policy.seed)``); microbatch ``i`` of step ``s`` draws from
        ``fold_stream(ft_key, s, i)``.
      fat_ramp: steps of linear BER warm-up (``fat_ber_at``).
      ft_backend: the ``protect_linear`` backend of every site.
      masks: per-site importance masks for the recompute policies.
    """
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    from repro_torch.ft import as_policy
    from repro_torch.models.common import FTCtx

    n_accum = model.run.grad_accum
    loss_fn = make_loss_fn(model)
    pol = as_policy(policy)
    if pol is not None:
        target_ber = float(pol.ber if ft_ber is None else ft_ber)

    def step(state, batch):
        ftc_at, fat_metrics = None, {}
        if pol is not None:
            counter = state["step"]
            ber_t = fat_ber_at(target_ber, fat_ramp, counter)
            pol_t = pol.with_ber(ber_t)
            root = (prng.as_key(ft_key, counter.device) if ft_key is not None
                    else prng.PRNGKey(pol.seed, counter.device))
            k_step = fold_stream(root, counter)

            def ftc_at(i):
                return FTCtx(pol_t, fold_stream(k_step, i), masks,
                             backend=ft_backend, ste=True)
            fat_metrics = {"fat_ber": ber_t}
        loss, grads = _accumulate(loss_fn, state["params"], batch, n_accum,
                                  ftc_at)
        opt_state = {"m": state["m"], "v": state["v"], "step": state["step"]}
        new_p, new_opt, om = adamw_update(grads, opt_state, state["params"],
                                          opt_cfg, inplace=donate)
        return {"params": new_p, **new_opt}, {"loss": loss, **om,
                                              **fat_metrics}
    return step


def make_prefill_step(model, mesh=None):
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)

    def pf(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch)
    return pf


def make_decode_step(model, mesh=None):
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)

    def dec(params, caches, token, pos):
        with torch.no_grad():
            return model.decode_step(params, caches, token, pos)
    return dec
