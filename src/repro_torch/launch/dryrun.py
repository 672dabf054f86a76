"""Production-mesh dry run: does each (architecture x input shape) cell fit
one card of a (16, 16) or (2, 16, 16) mesh, and what does its step move
over the wire?

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each step for 256 or 512 XLA host devices and reads XLA's memory and cost
analyses and the collectives of the post-SPMD HLO.  The port runs eagerly,
so its dry run *runs* each step once, as rank 0 of a fake process group of
the mesh's size (``torch.distributed``'s "fake" backend: a collective
returns at once and moves nothing), on fake tensors (``FakeTensorMode``:
shapes, dtypes and devices without storage, so nothing is allocated and no
kernel launches).  The step is built as the real one is
(``make_train_step`` / ``make_prefill_step`` / ``make_decode_step`` with
``mesh=``) and takes what rank 0 would: its shards of the train state, or
of the serving-layout parameters (``param_shardings(no_fsdp=True)``) and
the caches, under the partition rules (``parallel.sharding``), and the
whole batch.  Per cell it records:

  * ``persistent_bytes``: the state or parameters, caches and batch of one
    device from the rules' local shapes and the reference's dtypes (its
    ``_sharded_bytes``);
  * ``peak_bytes``: the most bytes the step holds live at once on rank 0,
    its inputs included (``StepMeter``: each storage rounded up to the
    CUDA caching allocator's 512-byte blocks), the counterpart of
    ``torch.cuda.max_memory_allocated`` over the step less what the
    process held besides its inputs; ``fits``: whether it fits one NVIDIA
    H100 80GB HBM3 (``H100_80GB_HBM3_BYTES``);
  * ``flops``: rank 0's FLOPs (``FlopCounterMode``'s rules), every layer
    and loop trip counted where it runs (XLA's ``cost_analysis`` counts a
    scan body once);
  * ``collectives``: counts and per-device wire bytes by op
    (``parallel.ctx.COLLECTIVES`` / ``WIRE_BYTES``: the ring formulas of
    ``ctx.wire_bytes``), a collective counted each time it runs;
  * ``trace_s``: the dry run's own seconds.

What it sees: the rules' shard shapes, the step's live memory on one rank,
its FLOPs and its collectives' bytes by formula.  What it cannot see:
NCCL's own buffers (outside the caching allocator), the allocator's
fragmentation and its rounding of large blocks, library workspaces, and
time on the card or on the wire.

The fake tensors live on the card's device type where torch has CUDA and
on the CPU otherwise (a CPU-only torch cannot differentiate a fake CUDA
tensor); the step runs the same ops either way.  The train step's tokens
are int64, the port's index type (``data.pipeline``); the persistent
figure counts the reference's int32.

Results land incrementally in
dryrun_results_torch/<mesh><tag>/<arch>__<shape>.json.

Usage:
  python -m repro_torch.launch.dryrun [--arch A] [--shape S] \
      [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import tree
from repro_torch.configs import (ARCHS, SHAPES, cells, get_config,
                                 get_run_config)
from repro_torch.launch.mesh import PRODUCTION, make_production_mesh
from repro_torch.models import build
from repro_torch.optim import AdamWConfig
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as S
from repro_torch.train.train_step import (init_state, make_decode_step,
                                          make_prefill_step, make_train_step,
                                          state_shardings)

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../dryrun_results_torch")
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (chip_smoke.py checks it on the card)
H100_80GB_HBM3_BYTES = 85_017_493_504
# the CUDA caching allocator rounds every block up to a multiple of this
ALLOC_ROUND = 512


def fake_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks, this process rank 0
    (any group it replaces is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_mesh(shape, names):
    """A DeviceMesh over a fake group of ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_group(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


class StepMeter(TorchDispatchMode):
    """The bytes of the storages alive at once and the FLOPs of the ops run
    under it.  An op's output storage is counted when it first appears
    (rounded up to ``ALLOC_ROUND``) and dropped when it is freed; ``peak``
    is the most.  FLOPs follow ``FlopCounterMode``'s rules (its registry of
    matmul, convolution and attention ops), counted here so that one mode
    sees each op (the two modes stacked took twice the time)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.live = self.peak = self.flops = 0
        self._seen = WeakIdKeyDictionary()
        self._flop_rules = flop_registry

    def _free(self, n, _ref):
        self.live -= n

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._seen[st] = weakref.ref(st, lambda r, n=n: self._free(n, r))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE:       # autograd asks each tensor's device
            return out
        rule = self._flop_rules.get(func.overloadpacket)
        if rule is not None:
            self.flops += rule(*args, **kwargs, out_val=out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out


_DEVICE = torch.ops.prim.device.default


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def local_bytes(specs_tree, shardings, mesh) -> int:
    """One device's bytes of a tree of whole (meta) tensors under a spec
    tree of the same structure: the rules' local shapes."""
    return sum(_nbytes(S.local_shape(x.shape, S._lookup(shardings, p), mesh),
                       x.dtype) for p, x in S.paths(specs_tree))


def _shards(specs_tree, shardings, mesh, dev):
    """Empty tensors of rank 0's local shapes (fake under FakeTensorMode)."""
    return S._map_path(lambda p, x: torch.empty(
        S.local_shape(x.shape, S._lookup(shardings, p), mesh),
        dtype=x.dtype, device=dev), specs_tree)


def _whole(specs_tree, dev):
    """Empty whole tensors (the batch: every rank takes it whole); tokens
    int64, the port's index type."""
    return tree.tree_map(lambda x: torch.empty(
        x.shape, dtype=torch.int64 if x.dtype == torch.int32 else x.dtype,
        device=dev), specs_tree)


def layout(model, shape, mesh) -> dict:
    """The persistent inputs of ``shape``'s step, ``{name: (whole meta
    tree, spec tree)}``: the train state (``state_shardings``) and the
    batch; or the serving-layout parameters (``param_shardings(no_fsdp=
    True)``, what ``make_prefill_step`` / ``make_decode_step(mesh=)``
    take) and the batch (prefill) or the caches (decode).  ``mesh`` may be
    a ``sharding.AbstractMesh``."""
    if shape.kind == "train":
        opt_cfg = AdamWConfig(dtype=model.run.adam_dtype)
        state = init_state(model, torch.Generator(), opt_cfg, device="meta")
        out = {"state": (state, state_shardings(state, mesh))}
    else:
        params = model.param_specs()
        out = {"params": (params, S.param_shardings(params, mesh,
                                                    no_fsdp=True))}
    if shape.kind == "decode":
        caches = model.cache_specs(shape.global_batch, shape.seq_len)
        out["caches"] = (caches, S.cache_shardings(
            caches, mesh, unrolled=model.cfg.unroll))
    else:
        batch = model.batch_specs(shape)
        out["batch"] = (batch, S.batch_shardings(batch, mesh))
    return out


def persistent_bytes(model, shape, mesh, lay=None) -> int:
    """One device's bytes of the step's persistent inputs (``layout``, or
    ``lay`` where given), from the rules' local shapes."""
    lay = lay or layout(model, shape, mesh)
    return sum(local_bytes(t, sh, mesh) for t, sh in lay.values())


def plan(model, shape, mesh):
    """(step, inputs, persistent bytes) of one cell: the step built as the
    real one is, ``inputs(dev)`` its arguments on rank 0 (to be made under
    the fake mode): its shards of the state, or of the parameters and
    caches, and the whole batch, as every rank takes it."""
    lay = layout(model, shape, mesh)
    persistent = persistent_bytes(model, shape, mesh, lay)

    def shards(name, dev):
        return _shards(*lay[name], mesh, dev)
    if shape.kind == "train":
        step = make_train_step(model, AdamWConfig(
            dtype=model.run.adam_dtype), mesh=mesh)
        return (step, lambda dev: (shards("state", dev),
                                   _whole(lay["batch"][0], dev)), persistent)
    if shape.kind == "prefill":
        step = make_prefill_step(model, mesh=mesh)
        return (step, lambda dev: (shards("params", dev),
                                   _whole(lay["batch"][0], dev)), persistent)
    step = make_decode_step(model, mesh=mesh)

    def inputs(dev):
        return (shards("params", dev), shards("caches", dev),
                torch.empty((shape.global_batch,), dtype=torch.int64,
                            device=dev),
                torch.empty((), dtype=torch.int32, device=dev))
    return step, inputs, persistent


def lower_model(model, shape, mesh) -> dict:
    """Run ``model``'s step for ``shape`` (a ``ShapeConfig``) once as rank 0
    of ``mesh`` (a DeviceMesh over a fake group) on fake tensors; returns
    the figures of the module docstring."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    step, inputs, persistent = plan(model, shape, mesh)
    dev = fake_device()
    pctx.COLLECTIVES.clear()
    pctx.WIRE_BYTES.clear()
    t0 = time.perf_counter()
    with FakeTensorMode(), StepMeter() as meter:
        args = inputs(dev)
        input_bytes = meter.live
        out = step(*args)
        del args, out
    trace_s = time.perf_counter() - t0
    wire = {k: float(v) for k, v in sorted(pctx.WIRE_BYTES.items())}
    return {
        "kind": shape.kind, "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "mesh": {k: int(v) for k, v in pctx.mesh_shape(mesh).items()},
        "n_devices": int(math.prod(pctx.mesh_shape(mesh).values())),
        "fake_device": dev.type, "trace_s": trace_s,
        "memory": {"persistent_bytes": persistent,
                   "input_bytes": input_bytes, "peak_bytes": meter.peak,
                   "card_bytes": H100_80GB_HBM3_BYTES,
                   "fits": meter.peak <= H100_80GB_HBM3_BYTES},
        "flops": int(meter.flops),
        "collectives": {"count": dict(sorted(pctx.COLLECTIVES.items())),
                        "wire_bytes": wire,
                        "total_wire_bytes": sum(wire.values())},
    }


def lower_cell(arch: str, shape_name: str, mesh, ft_emu: str = "") -> dict:
    """One cell on ``mesh``.  ``ft_emu`` runs the train step's loss under
    the FlexHyCA cost emulation (``models.common.EmuCtx``: "two_pass" or
    "fused"), as the reference's flag does.  The serving cells always take
    ``param_shardings(no_fsdp=True)`` shards, the reference's
    ``--serve-replicated`` layout."""
    cfg = get_config(arch)
    run = get_run_config(arch)
    if ft_emu:
        run = dataclasses.replace(run, ft_emu=ft_emu)
    shape = SHAPES[shape_name]
    if not cfg.supports(shape):
        return {"skipped": True,
                "reason": "long_500k requires sub-quadratic attention"}
    res = {"arch": arch, "shape": shape_name, "ft": ft_emu}
    res.update(lower_model(build(cfg, run), shape, mesh))
    return res


def _gb(n) -> str:
    return f"{n / 1e9:.2f}GB"


def table(out_dir, meshes=("single", "multi")) -> str:
    """The results under ``out_dir`` as a markdown table: a row per cell of
    ``cells()``, each figure given per mesh, joined by " / "."""
    cols = (("persistent GB", lambda r: r["memory"]["persistent_bytes"]
             / 1e9), ("peak GB", lambda r: r["memory"]["peak_bytes"] / 1e9),
            ("fits", lambda r: "yes" if r["memory"]["fits"] else "NO"),
            ("all_gather GB", lambda r: r["collectives"]["wire_bytes"].get(
                "all_gather", 0.0) / 1e9),
            ("all_reduce GB", lambda r: r["collectives"]["wire_bytes"].get(
                "all_reduce", 0.0) / 1e9),
            ("TFLOP", lambda r: r["flops"] / 1e12),
            ("trace s", lambda r: r["trace_s"]))
    lines = ["| arch | shape | " + " | ".join(c for c, _ in cols) + " |",
             "| --- | --- |" + " --- |" * len(cols)]
    for arch, shape in cells():
        got = []
        for mesh in meshes:
            path = os.path.join(out_dir, mesh, f"{arch}__{shape}.json")
            got.append(json.load(open(path)) if os.path.exists(path)
                       else None)
        row = []
        for _, fn in cols:
            vals = ["-" if r is None else "failed" if r.get("failed")
                    else fn(r) for r in got]
            row.append(" / ".join(f"{v:.3f}" if isinstance(v, float)
                                  else str(v) for v in vals))
        lines.append(f"| {arch} | {shape} | " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--tp", type=int, default=0,
                    help="override: logical mesh (256//tp, tp) on one pod")
    ap.add_argument("--ft", default="", choices=["", "two_pass", "fused"])
    ap.add_argument("--serve-replicated", action="store_true",
                    help="accepted for the reference's command line and "
                         "ignored: the port's serving steps always take "
                         "param_shardings(no_fsdp=True) shards")
    ap.add_argument("--tag", default="",
                    help="results subdir tag for hillclimb variants")
    ap.add_argument("--table", action="store_true",
                    help="print the results under --out as a markdown "
                         "table (single / multi) and run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out))
        return 0

    meshes = []
    if args.tp:
        meshes.append((f"single_tp{args.tp}", lambda: fake_mesh(
            (256 // args.tp, args.tp), ("data", "model"))))
    else:
        for name, multi in (("single", False), ("multi", True)):
            if args.mesh in (name, "both"):
                meshes.append((name, lambda multi=multi: _production(multi)))

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)

    n_ok = n_skip = n_fail = 0
    for mesh_name, make in meshes:
        outdir = os.path.join(args.out, mesh_name + args.tag)
        os.makedirs(outdir, exist_ok=True)
        mesh = make()
        for arch in archs:
            for shape in shapes:
                path = os.path.join(outdir, f"{arch}__{shape}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {mesh_name} {arch} {shape}")
                    continue
                print(f"[run   ] {mesh_name} {arch} {shape} ...", flush=True)
                try:
                    res = lower_cell(arch, shape, mesh, ft_emu=args.ft)
                    if res.get("skipped"):
                        n_skip += 1
                        print(f"[skip  ] {arch} {shape}: {res['reason']}")
                    else:
                        n_ok += 1
                        mm = res["memory"]
                        print(f"[ok    ] {arch} {shape} "
                              f"trace={res['trace_s']:.1f}s "
                              f"peak/dev={_gb(mm['peak_bytes'])} "
                              f"persistent={_gb(mm['persistent_bytes'])} "
                              f"fits={mm['fits']} "
                              f"tflop={res['flops'] / 1e12:.1f} coll="
                              f"{_gb(res['collectives']['total_wire_bytes'])}",
                              flush=True)
                except Exception:
                    n_fail += 1
                    res = {"arch": arch, "shape": shape, "failed": True,
                           "error": traceback.format_exc()}
                    print(f"[FAIL  ] {arch} {shape}\n{res['error']}",
                          flush=True)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
        dist.destroy_process_group()
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    return n_fail


def _production(multi: bool):
    fake_group(math.prod(PRODUCTION[multi][0]))
    return make_production_mesh(multi_pod=multi, device="cpu")


if __name__ == "__main__":
    raise SystemExit(main())
