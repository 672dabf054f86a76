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
checkpoint continues the exact fault stream.

On a mesh (``mesh=``, a DeviceMesh) the parameters and both moments rest in
the FSDP x TP layout (``state_shardings``: each rank holds its shard of
every leaf, ``shard_state`` cuts a whole state so).  A step gathers the
parameters whole (the MoE experts stay on their 'model' rank), splits each
microbatch's rows over the dp axes (the reference's microbatches are the
global batch's row blocks, each split over dp), and runs the model under
the mesh context, whose collectives differentiate (``parallel.ctx``).  The
gradients are summed over dp and divided by its size, so the loss is the
global batch's mean; the clipping norm is taken over the whole gradients,
and AdamW updates each rank's shard of the parameters and moments.  FAT
draws the same ``fold_stream(root, step, mb)`` keys: a protected
projection under one key computes on the whole microbatch's rows.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.faults import fold_stream
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.adamw import global_norm
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as S
from repro_torch.tree import items, leaves, tree_map


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


def _accumulate(loss_fn, params, batch, n_accum: int, ftc_at=None,
                ctx=None):
    """Mean (loss, grads) over ``n_accum`` microbatches (rows split in
    order), gradients accumulated in the parameters' dtypes.  ``ftc_at(i)``
    builds microbatch ``i``'s fault context, so each draws from its own
    fold of the step key.  Under a mesh context ``ctx`` each microbatch's
    rows are split over dp where they divide, and the loss and gradients
    are summed over dp and divided by its size."""
    if ctx is not None:
        B = next(iter(batch.values())).shape[0]
        c = ctx.for_rows(B // max(n_accum, 1))

        def local_loss(p, mb, ftc):
            with pctx.mesh_ctx(c):
                return loss_fn(p, {k: pctx.local_rows(v, c)
                                   for k, v in mb.items()}, ftc)
        loss, grads = _accumulate(local_loss, params, batch, n_accum, ftc_at)
        if c.rows:
            n = float(c.dp_size)
            loss = pctx.all_reduce(c, loss, "dp") / n
            grads = tree_map(lambda g: pctx.all_reduce(c, g, "dp") / n,
                             grads)
        return loss, grads
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


def _whole_norm(ctx, grads) -> torch.Tensor:
    """The global norm of the whole gradients, where the MoE experts' are
    this rank's (their squares summed over 'model') and every other leaf's
    whole."""
    named = [(n.split("/"), g) for n, g in items(grads)]   # leaves() order
    whole = [g for p, g in named if not S.keep_experts(p, g)]
    local = [g for p, g in named if S.keep_experts(p, g)]
    if not local:
        return global_norm(whole)
    return torch.sqrt(torch.square(global_norm(whole)) + pctx.all_reduce(
        ctx, torch.square(global_norm(local)), "tp"))


def state_shardings(state, mesh):
    """Spec tree of a train state (whole shapes; ``init_state(...,
    device="meta")`` gives them without memory): the moments follow their
    parameters (``param_spec``), the step counter is replicated."""
    return {k: (S.param_shardings(v, mesh) if k in ("params", "m", "v")
                else S.P()) for k, v in state.items()}


def shard_state(state, mesh, specs=None):
    """This rank's shards of a whole train state."""
    return S.distribute(state, specs or state_shardings(state, mesh), mesh)


def unshard_state(state, specs, mesh):
    """The whole train state from every rank's shards (``specs``: the
    whole state's ``state_shardings``)."""
    return S.gather_tree(state, specs, mesh)


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

    With ``mesh`` the state is this rank's shards (``shard_state``), the
    batch the whole global batch, the same on every rank; the returned
    state is the updated shards and the metrics are the global batch's.
    """
    from repro_torch.ft import as_policy
    from repro_torch.models.common import FTCtx

    n_accum = model.run.grad_accum
    loss_fn = make_loss_fn(model)
    pol = as_policy(policy)
    if pol is not None:
        target_ber = float(pol.ber if ft_ber is None else ft_ber)
    ctx = specs = None
    if mesh is not None:
        S.check_model(model.cfg, mesh)
        ctx = S.make_ctx(mesh)
        specs = state_shardings(
            init_state(model, torch.Generator(), opt_cfg, device="meta"),
            mesh)["params"]

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
        params, gnorm = state["params"], None
        if mesh is not None:
            params = S.gather_tree(params, specs, mesh, keep=S.keep_experts)
        loss, grads = _accumulate(loss_fn, params, batch, n_accum, ftc_at,
                                  ctx)
        if mesh is not None:
            del params
            gnorm = _whole_norm(ctx, grads)
            grads = S.distribute(grads, specs, mesh, keep=S.keep_experts)
        opt_state = {"m": state["m"], "v": state["v"], "step": state["step"]}
        new_p, new_opt, om = adamw_update(grads, opt_state, state["params"],
                                          opt_cfg, inplace=donate,
                                          grad_norm=gnorm)
        return {"params": new_p, **new_opt}, {"loss": loss, **om,
                                              **fat_metrics}
    return step


def _serving(model, mesh):
    """(ctx, gather): the mesh context and the function that gathers a
    serving-layout parameter tree whole (None, None without a mesh)."""
    if mesh is None:
        return None, None
    whole = model.init(torch.Generator(), device="meta")
    specs = S.param_shardings(whole, mesh, no_fsdp=True)
    return S.make_ctx(mesh), lambda p: S.gather_tree(p, specs, mesh,
                                                    keep=S.keep_experts)


def make_prefill_step(model, mesh=None):
    """``pf(params, batch) -> (caches, logits)``.  With ``mesh``: params are
    this rank's serving-layout shards (``param_shardings(no_fsdp=True)``),
    the batch is whole; the caches are this rank's (``cache_shardings``)
    and the logits the whole batch's."""
    ctx, gather = _serving(model, mesh)

    def pf(params, batch):
        with torch.no_grad():
            if ctx is None:
                return model.prefill(params, batch)
            c = ctx.for_rows(batch["tokens"].shape[0])
            with pctx.mesh_ctx(c):
                caches, logits = model.prefill(
                    gather(params),
                    {k: pctx.local_rows(v) for k, v in batch.items()})
                return caches, pctx.gather_rows(logits)
    return pf


def make_decode_step(model, mesh=None):
    """``dec(params, caches, token, pos) -> (caches, logits)``; with
    ``mesh`` as ``make_prefill_step``'s (the whole batch's tokens in, its
    logits out; this rank's caches)."""
    ctx, gather = _serving(model, mesh)

    def dec(params, caches, token, pos):
        with torch.no_grad():
            if ctx is None:
                return model.decode_step(params, caches, token, pos)
            c = ctx.for_rows(token.shape[0])
            with pctx.mesh_ctx(c):
                caches, logits = model.decode_step(
                    gather(params), caches, pctx.local_rows(token),
                    pctx.local_rows(pos) if torch.is_tensor(pos) and pos.dim()
                    else pos)
                return caches, pctx.gather_rows(logits)
    return dec
