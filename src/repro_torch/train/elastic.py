"""Elastic re-meshing: continue training after losing ranks.

Counterpart of ``repro.train.elastic``.  The FSDP ('data') axis absorbs the
size change; 'model' stays fixed, so the TP layout is stable.  Checkpoints
are mesh-agnostic (named leaves, whole logical shapes: a sharded ``save``
gathers first), so rescaling is: form the survivors' mesh -> recompute the
shardings -> restore -> continue.  The global batch is preserved exactly by
raising grad_accum when the dp world shrinks: the new data axis is the
largest divisor of the old one that fits the survivors, so ``new_dp *
grad_accum_scale == old_dp`` always holds.  Gained capacity beyond the old
world is left idle.

The survivors form their own process groups (``dist.new_group`` with local
synchronization: only they take part, as after a real loss) and a new
``DeviceMesh`` over them; a rank that is not among them gets None and
leaves.  The closed loop lives on the Trainer: ``simulate_device_loss`` ->
``Trainer.handle_device_loss`` (plan_rescale + survivor_mesh +
remesh_restore) -> ``Trainer.run(state, step)``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding as S
from repro_torch.parallel.ctx import mesh_shape
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import state_shardings


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_dp: int
    new_dp: int
    grad_accum_scale: int   # multiply RunConfig.grad_accum by this

    @property
    def changed(self) -> bool:
        return self.old_dp != self.new_dp


def plan_rescale(old_mesh, surviving_devices: int,
                 model_axis: int) -> ElasticPlan:
    """Choose the largest data axis that fits the survivors.

    Invariants: ``1 <= new_dp <= old_dp`` and ``old_dp % new_dp == 0``;
    ``new_dp * grad_accum_scale == old_dp`` (the global batch preserved);
    nothing changed => the identity plan."""
    sh = mesh_shape(old_mesh)
    old_dp = sh.get("data", 1) * sh.get("pod", 1)
    fit = max(surviving_devices // model_axis, 1)
    new_dp = max(d for d in range(1, old_dp + 1)
                 if old_dp % d == 0 and d <= fit)
    return ElasticPlan(old_dp=old_dp, new_dp=new_dp,
                       grad_accum_scale=old_dp // new_dp)


def simulate_device_loss(mesh, n_lost: int) -> list:
    """Drop the last ``n_lost`` ranks of the mesh, the stand-in for a real
    host failure.  Returns the surviving global ranks."""
    ranks = [int(r) for r in mesh.mesh.flatten()]
    if not 0 <= n_lost < len(ranks):
        raise ValueError(f"cannot lose {n_lost} of {len(ranks)} ranks")
    return ranks[:len(ranks) - n_lost]


def survivor_mesh(plan: ElasticPlan, model_axis: int, ranks: list,
                  device_type: str = "cuda"):
    """The (data, model) DeviceMesh of the plan over the first ``new_dp x
    model_axis`` survivors; None on a rank that is not in it.  Each member
    forms the groups of its own row and column, with the other members
    only."""
    from torch.distributed.device_mesh import DeviceMesh
    need = plan.new_dp * model_axis
    if len(ranks) < need:
        raise ValueError(f"plan needs {need} ranks, {len(ranks)} survive")
    grid = torch.tensor(ranks[:need]).reshape(plan.new_dp, model_axis)
    me = dist.get_rank()
    if me not in grid.flatten().tolist():
        return None
    groups = []
    for d in range(grid.dim()):
        lines = grid.movedim(d, -1).reshape(-1, grid.shape[d]).tolist()
        mine = next(line for line in lines if me in line)
        groups.append(dist.new_group(mine, use_local_synchronization=True))
    return DeviceMesh.from_group(groups, device_type, mesh=grid,
                                 mesh_dim_names=("data", "model"))


def remesh_restore(ckpt_dir: str, like_state, new_mesh, device=None):
    """Restore the latest checkpoint onto a new mesh's shardings
    (``like_state``: the whole state's structure, meta tensors will do).
    Returns (state shards, step, data state, the mesh context)."""
    sh = state_shardings(like_state, new_mesh)
    state, step, dstate = ckpt.restore(ckpt_dir, like_state, device=device,
                                       shardings=sh, mesh=new_mesh)
    if state is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    return state, step, dstate, S.make_ctx(new_mesh)
