"""Mesh builders.

Counterpart of ``repro.launch.mesh``.  Functions, not module-level
constants, so importing touches no process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims over the
default process group: NCCL on the card, gloo on the CPU.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import device as _device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def backend_of(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_local_group(device=None) -> None:
    """A one-rank default process group from a ``file://`` store in the
    temporary directory, where none exists (no network)."""
    if dist.is_initialized():
        return
    dev = _device.resolve(device)
    fd, path = tempfile.mkstemp(prefix="repro_torch_pg_")
    os.close(fd)
    os.remove(path)
    kw = {}
    if dev.type == "cuda":
        idx = (dev.index if dev.index is not None
               else torch.cuda.current_device())
        torch.cuda.set_device(idx)
        kw["device_id"] = torch.device("cuda", idx)
    dist.init_process_group(backend_of(dev), init_method=f"file://{path}",
                            world_size=1, rank=0, **kw)


def _device_type(device) -> str:
    return _device.resolve(device).type


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks, ('data', 'model'); 2 x 16 x 16 = 512 ranks with
    'pod' in front under ``multi_pod``.  Needs a default process group of
    exactly that many ranks (``torchrun``)."""
    shape, names = PRODUCTION[multi_pod]
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the production mesh {dict(zip(names, shape))} needs {need} "
            f"ranks; this process group has {world} (launch {need} ranks "
            "with torchrun, or use make_local_mesh)")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=names)


def make_local_mesh(device=None):
    """The 1 x 1 ('data', 'model') mesh of a one-rank group, which it
    initializes where none exists (NCCL on ``cuda``, the default; gloo on
    the CPU)."""
    init_local_group(device)
    if dist.get_world_size() != 1:
        raise ValueError("make_local_mesh is the one-rank mesh; this process "
                         f"group has {dist.get_world_size()} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), (1, 1),
                            mesh_dim_names=("data", "model"))
