"""Step-atomic checkpoints with async write and resume-latest.

Counterpart of ``repro.train.checkpoint``, with its on-disk layout:

    <dir>/step_<N>/   arrays.npz (one entry per leaf, named by its path
                                  of keys joined by "/")
                      meta.json  {step, names, data_state}
    <dir>/step_<N>.done          (the commit marker)

A write goes to ``<dir>/.tmp_step_<N>``, which is renamed into place before
the marker is written, so a half-written checkpoint is never restored.
Leaves are stored as the reference stores them: float32 and int32 as
themselves, bfloat16 as its 2 raw bytes per element (numpy has no bfloat16,
so both packages write a 2-byte void type), and restored into the dtypes of
a ``like`` tree: a checkpoint the reference wrote restores into the port's
state by name (the reference's own ``restore`` cannot cast the bf16 bytes
back, so it reads only float32 and integer leaves).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.tree import items, map_named


class _Waiter:
    """Handle of an async checkpoint write.  ``join()`` waits for the
    writer and re-raises its failure, so a crashed background write is
    never taken for a committed checkpoint; the commit marker is written
    only after a write succeeded."""

    def __init__(self, target):
        self._exc: BaseException | None = None

        def _run():
            try:
                target()
            except BaseException as e:   # re-raised at join()
                self._exc = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)
        if self._exc is not None:
            raise self._exc

    def is_alive(self) -> bool:
        return self._thread.is_alive()


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    # a copy also on the CPU: the trainer updates its state in place while
    # an async write of it runs
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree) -> dict:
    """{name: numpy array} of every leaf, copied to the host."""
    return {name: _to_numpy(leaf) for name, leaf in items(tree)}


def save(ckpt_dir: str, state, step: int, data_state: dict | None = None,
         keep: int = 3, async_write: bool = False, shardings=None,
         mesh=None):
    """Write the checkpoint of ``step``.  The state is copied to the host
    before this returns; with ``async_write`` the files are written by a
    thread, whose waiter this returns (``None`` otherwise).

    A sharded state (``mesh`` and its whole spec tree ``shardings``) is
    gathered first, so the files hold the whole logical shapes and restore
    onto any mesh; every rank of the mesh takes part in the gather and the
    mesh's first rank writes."""
    if mesh is not None:
        from repro_torch.parallel import sharding as S
        state = S.gather_tree(state, shardings, mesh)
        if torch.distributed.get_rank() != int(mesh.mesh.flatten()[0]):
            return None
    arrays = _flatten(state)

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "names": sorted(arrays),
                       "data_state": data_state or {}}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        open(final + ".done", "w").close()
        _gc(ckpt_dir, keep)

    if async_write:
        return _Waiter(_write)
    _write()
    return None


def _gc(ckpt_dir: str, keep: int):
    """Prune to the newest ``keep`` committed steps (``keep=0`` keeps all);
    uncommitted directories are never touched."""
    steps = sorted(available_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
        try:
            os.remove(os.path.join(ckpt_dir, f"step_{s}.done"))
        except OSError:
            pass


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for n in os.listdir(ckpt_dir):
        if n.startswith("step_") and not n.endswith(".done"):
            if os.path.exists(os.path.join(ckpt_dir, n + ".done")):
                out.append(int(n.split("_")[1]))
    return sorted(out)


def _leaf(arr: np.ndarray, like, device) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    if arr.dtype.kind == "V":               # bfloat16's raw bytes
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=like.dtype)


def restore(ckpt_dir: str, like, step: int | None = None, device=None,
            shardings=None, mesh=None):
    """Restore the latest (or the given) committed step into the structure
    and dtypes of ``like`` (a tree of tensors of the whole shapes; meta
    tensors will do), on ``device`` (default the GPU); with ``mesh`` and
    ``shardings`` (``like``'s spec tree) each rank keeps its shards.
    Returns (state, step, data_state), or (None, -1, {}) where no step is
    committed."""
    steps = available_steps(ckpt_dir)
    if not steps:
        return None, -1, {}
    step = steps[-1] if step is None else step
    dev = _device.resolve(device)
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        state = map_named(lambda name, leaf: _leaf(z[name], leaf, dev), like)
    if mesh is not None:
        from repro_torch.parallel import sharding as S
        state = S.distribute(state, shardings, mesh)
    return state, step, meta.get("data_state", {})
