"""The port's production-mesh dry run (``repro_torch.launch.dryrun``) held
to the reference's (``repro.launch.dryrun``) on the CPU:

  * ``configs.cells()`` equals the reference's, with and without skips;
  * ``Model.batch_specs``, ``cache_specs`` (decode_32k) and ``param_specs``
    equal the reference's ``jax.eval_shape`` trees leaf for leaf in shape
    and dtype, for every architecture at full width (the reference stacks
    scanned segments along a leading axis, the port keeps one dict per
    layer);
  * persistent bytes per device (``dryrun.persistent_bytes``) on (16, 16)
    and (2, 16, 16): every train cell's equal the reference's
    ``_sharded_bytes`` of its state and batch, recomputed from
    ``repro.parallel.sharding``'s rules on a jax AbstractMesh; every
    serving cell's equal the reference's ``--serve-replicated`` layout
    (``param_shardings(no_fsdp=True)``) with its batch or caches, except
    the k/v caches whose kv heads do not divide 'model' (``SPLIT_K``),
    which the reference splits by length and the port holds whole over
    'model' (ROADMAP §C);
  * ``parallel.ctx.wire_bytes`` equals the reference's ``wire_bytes`` on
    hand-written HLO lines of the two collectives the port issues;
  * end to end, on reduced danube and qwen3-moe (train and decode): a fake
    (1, 1) dry run counts the collectives, by kind, that the same step
    counts on a real one-rank gloo group; on a fake (2, 2) mesh the train
    step's parameter gather moves the wire bytes the rules' shard shapes
    give; the dry run's FLOPs equal ``FlopCounterMode``'s.

The end-to-end part and the reference's ring formulas run in one
subprocess (this file run as a script; one thread, a timeout): importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices, and a fake
default process group would outlive its test in this process.

The file holds 7 tests, each looping over its architectures and meshes:
pytest-xdist's ``--dist loadfile`` hands out the files with the most
tests first, and a file of at most 7 follows ``tests/test_serve_sharded.py``
(7 tests, ~900 s, the suite's critical path) instead of delaying it.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the architectures whose kv heads do not divide a 16-way 'model' axis:
# their dense k/v caches are whole over 'model' in the port
SPLIT_K = {"glm4-9b", "qwen2-7b", "h2o-danube-1.8b", "dbrx-132b",
           "qwen3-moe-235b-a22b", "paligemma-3b", "recurrentgemma-9b"}
E2E_ARCHS = ("h2o-danube-1.8b", "qwen3-moe-235b-a22b")
TIMEOUT = 240
HLO_LINES = {
    "all_gather": ("%ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} "
                   "%p), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,"
                   "14,15}}, dimensions={0}", 16 * 4096 * 2, 16),
    "all_reduce": ("%ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), "
                   "replica_groups=[16,16]<=[256], to_apply=%add",
                   1024 * 4, 16),
}


def _env(**kw):
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
                **kw)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The end-to-end subprocess, started when the module's first test
    runs; ``e2e()`` waits for its results."""
    path = str(tmp_path_factory.mktemp("dryrun") / "e2e.json")
    proc = subprocess.Popen([sys.executable, __file__, path],
                            env=_env(JAX_PLATFORMS="cpu"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    out = {}

    def result():
        if not out:
            _, stderr = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, stderr[-4000:]
            out.update(json.load(open(path)))
        return out
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start(e2e):
    yield


# ------------------------------------------------------------ reference ---
def _jmesh(sizes, names):
    from jax.sharding import AbstractMesh
    try:  # jax >= 0.5: AbstractMesh(axis_sizes, axis_names)
        return AbstractMesh(sizes, names)
    except TypeError:  # jax 0.4.x: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(zip(names, sizes)))


def _jflat(tree):
    import jax
    return {tuple(str(getattr(k, "key", k)) for k in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dtype(x) -> str:
    import numpy as np
    if hasattr(x, "is_meta"):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


@pytest.fixture(scope="module")
def ref():
    """The reference's models and their spec trees, per architecture."""
    import jax
    from repro.configs import ARCHS, get_config, get_run_config
    from repro.models import build
    out = {}
    for arch in ARCHS:
        m = build(get_config(arch), get_run_config(arch))
        out[arch] = dict(model=m, params=m.param_specs(),
                         caches=m.cache_specs(128, 32768))
    return out


def _shard_bytes(tree, shardings, sizes, split_k=False):
    """The reference's ``_sharded_bytes`` of a tree under a NamedSharding
    tree, from the specs and the mesh's axis sizes; ``split_k`` keeps
    whole the dense k/v/ck/cv length the reference splits over 'model'."""
    specs = _jflat(shardings)
    tot = 0
    for path, leaf in _jflat(tree).items():
        spec = list(specs[path].spec)
        shape = list(leaf.shape)
        for d, e in enumerate(spec):
            if e is None:
                continue
            axes = (e,) if isinstance(e, str) else tuple(e)
            if (split_k and path[-1] in ("k", "v", "ck", "cv")
                    and d == len(shape) - 3 and axes == ("model",)):
                continue
            shape[d] //= math.prod(sizes[a] for a in axes)
        tot += math.prod(shape) * leaf.dtype.itemsize
    return tot


def _ref_persistent(r, shape, mesh_key, split_k=False):
    import jax
    from repro.optim import AdamWConfig
    from repro.parallel import sharding as JS
    from repro.train.train_step import init_state, state_shardings
    sizes_t, names = MESHES[mesh_key]
    sizes = dict(zip(names, sizes_t))
    mesh = _jmesh(sizes_t, names)
    m = r["model"]
    batch = m.batch_specs(shape)
    if shape.kind == "train":
        if "state" not in r:     # one eval_shape per architecture
            opt = AdamWConfig(dtype=m.run.adam_dtype)
            r["state"] = jax.eval_shape(lambda k: init_state(m, k, opt),
                                        jax.random.PRNGKey(0))
        state = r["state"]
        return (_shard_bytes(state, state_shardings(state, mesh), sizes)
                + _shard_bytes(batch, JS.batch_shardings(batch, mesh), sizes))
    tot = _shard_bytes(r["params"], JS.param_shardings(
        r["params"], mesh, no_fsdp=True), sizes)
    if shape.kind == "prefill":
        return tot + _shard_bytes(batch, JS.batch_shardings(batch, mesh),
                                  sizes)
    key = (shape.global_batch, shape.seq_len)
    if key not in r:
        r[key] = m.cache_specs(*key)
    caches = r[key]
    return tot + _shard_bytes(caches, JS.cache_shardings(
        caches, mesh, unrolled=m.cfg.unroll), sizes, split_k)


# ---------------------------------------------------------------- port ----
def _port(arch):
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.models import build
    return build(get_config(arch), get_run_config(arch))


def _layer_map(cfg):
    """The reference's stacked (seg{si}, s{j}) of each port layer l{i}."""
    out, i = {}, 0
    for si, (pattern, n_rep) in enumerate(cfg.segments):
        for _ in range(n_rep):
            for j in range(len(pattern)):
                out[f"l{i}"] = (f"seg{si}", f"s{j}")
                i += 1
    return out


def _ref_path(path, cfg, stacked, caches=False):
    """(the reference's leaf path of a port leaf, whether it is stacked)."""
    if not stacked:
        return path, False
    if caches:
        return _layer_map(cfg)[path[0]] + path[1:], True
    if path[0] == "layers":
        return _layer_map(cfg)[path[1]] + path[2:], True
    if path[0] == "enc_layers":
        return ("enc_blocks", "s0") + path[2:], True
    return path, False


def _same_tree(port, ref_tree, cfg, caches=False):
    from repro_torch.parallel import sharding as S
    jref = _jflat(ref_tree)
    stacked = any(p[0].startswith("seg") for p in jref)
    seen, n_want = set(), 0
    for path, leaf in S.paths(port):
        rpath, st = _ref_path(tuple(path), cfg, stacked, caches)
        want = jref[rpath]
        shape = tuple(want.shape[1:] if st else want.shape)
        assert (tuple(leaf.shape), _dtype(leaf)) == (shape, _dtype(want)), (
            path, rpath)
        assert leaf.is_meta, path
        seen.add(rpath)
    for rpath, x in jref.items():
        n_want += x.shape[0] if rpath[0].startswith(("seg", "enc_blocks")) \
            else 1
    assert seen == set(jref)
    assert len(S.paths(port)) == n_want


# ---------------------------------------------------------------- tests ---
def test_cells():
    from repro.configs import cells as jcells
    from repro_torch.configs import cells
    for skips in (False, True):
        assert cells(skips) == jcells(skips)
    assert len(cells(True)) > len(cells())


def test_specs(ref):
    from repro.configs import ARCHS, SHAPES as JSHAPES
    for arch in ARCHS:
        m, r = _port(arch), ref[arch]
        _same_tree(m.param_specs(), r["params"], m.cfg)
        _same_tree(m.cache_specs(128, 32768), r["caches"], m.cfg,
                   caches=True)
        for name, shape in JSHAPES.items():
            _same_tree(m.batch_specs(shape), r["model"].batch_specs(shape),
                       m.cfg)


def test_persistent_bytes(ref):
    from repro.configs import SHAPES as JSHAPES
    from repro_torch.configs import SHAPES, cells
    from repro_torch.launch import dryrun as D
    from repro_torch.parallel import sharding as S
    for mesh_key in sorted(MESHES):
        mesh = S.AbstractMesh(*MESHES[mesh_key])
        departed, n = set(), 0
        for arch, shape_name in cells():
            got = D.persistent_bytes(_port(arch), SHAPES[shape_name], mesh)
            r, shape = ref[arch], JSHAPES[shape_name]
            want = _ref_persistent(r, shape, mesh_key)
            if shape.kind == "decode" and got != want:
                want = _ref_persistent(r, shape, mesh_key, split_k=True)
                departed.add(arch)
            assert got == want, (mesh_key, arch, shape_name, got, want)
            n += 1
        assert n == len(cells())
        assert departed == SPLIT_K, mesh_key


def test_table(tmp_path):
    """``--table``'s rows: a cell's figures per mesh (single / multi), a
    failed cell "failed", a cell not run "-"."""
    from repro_torch.configs import cells
    from repro_torch.launch import dryrun as D
    res = {"memory": {"persistent_bytes": 2e9, "peak_bytes": 9e10,
                      "fits": False},
           "collectives": {"wire_bytes": {"all_gather": 3e9}},
           "flops": 5e12, "trace_s": 1.5}
    for mesh, r in (("single", res), ("multi", {"failed": True})):
        (tmp_path / mesh).mkdir()
        (tmp_path / mesh / "glm4-9b__decode_32k.json").write_text(
            json.dumps(r))
    lines = D.table(str(tmp_path)).splitlines()
    assert len(lines) == 2 + len(cells())
    assert ("| glm4-9b | decode_32k | 2.000 / failed | 90.000 / failed | "
            "NO / failed | 3.000 / failed | 0.000 / failed | 5.000 / failed "
            "| 1.500 / failed |") in lines
    assert "| glm4-9b | train_4k | - / - |" in D.table(str(tmp_path))


def test_wire_bytes(e2e):
    """The ring formulas equal the reference's on its HLO lines; on a fake
    (2, 2) mesh the train step's parameter gather moves what the rules'
    shard shapes give, gathered axis by axis as ``gather_tree`` does."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.ctx import mesh_shape, wire_bytes
    want = e2e()["ring"]
    for kind, (_, out_bytes, group) in HLO_LINES.items():
        assert wire_bytes(kind, out_bytes, group) == want[kind], kind
    mesh = S.AbstractMesh((2, 2), ("data", "model"))
    sizes = mesh_shape(mesh)
    for arch in E2E_ARCHS:
        res = e2e()[f"gather/{arch}"]
        state, specs = D.layout(_reduced(arch), ShapeConfig(*TRAIN),
                                mesh)["state"]
        want = 0.0
        for path, leaf in S.paths(state["params"]):
            spec = S._lookup(specs["params"], path)
            shape = list(S.local_shape(leaf.shape, spec, mesh))
            kept = S.keep_experts(path, leaf)
            for d, e in enumerate(spec):
                for a in reversed((e,) if isinstance(e, str) else e or ()):
                    if a in kept:
                        continue
                    shape[d] *= sizes[a]
                    want += (math.prod(shape) * leaf.dtype.itemsize
                             * (sizes[a] - 1) / sizes[a])
        assert res["wire"] == want > 0, (arch, res, want)


def test_fake_counts_real_collectives(e2e):
    res = e2e()
    for arch in E2E_ARCHS:
        for kind in ("train", "decode"):
            fake = res[f"fake/{arch}/{kind}"]
            real = res[f"real/{arch}/{kind}"]
            assert fake == real and sum(real.values()) > 0, (
                arch, kind, fake, real)


def test_flops(e2e):
    """The dry run's FLOPs equal ``FlopCounterMode``'s on the same step;
    ``--ft two_pass`` adds the DPPU's second GEMM pass to every
    projection, ``fused`` protects in the same pass (no extra FLOPs)."""
    res = e2e()
    assert res["flops"]["meter"] == res["flops"]["flop_counter_mode"] > 0, (
        res["flops"])
    ft = res["ft_flops"]
    assert ft["two_pass"] > ft["fused"] == ft[""] > 0, ft


# ------------------------------------------------- the end-to-end part ----
TRAIN = ("t", "train", 16, 8)
DECODE = ("d", "decode", 16, 4)


def _reduced(arch):
    from repro_torch.configs import get_config, get_run_config
    from repro_torch.models import build
    return build(get_config(arch, reduced=True), get_run_config(arch))


def _real_step(model, shape, mesh):
    """Run ``shape``'s step on real CPU tensors on ``mesh``."""
    import torch
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as S
    from repro_torch.train import (init_state, make_decode_step,
                                   make_train_step, shard_state)
    g = torch.Generator().manual_seed(0)
    B, L = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt = AdamWConfig(dtype=model.run.adam_dtype)
        state = shard_state(init_state(model, g, opt, device="cpu"), mesh)
        batch = {"tokens": torch.randint(0, model.cfg.vocab, (B, L),
                                         generator=g)}
        return make_train_step(model, opt, mesh=mesh)(state, batch)
    params = model.init(g, device="cpu")
    params = S.distribute(params, S.param_shardings(params, mesh,
                                                    no_fsdp=True), mesh)
    caches = model.init_cache(B, L, device="cpu")
    caches = S.distribute(caches, S.cache_shardings(caches, mesh), mesh)
    tok = torch.randint(0, model.cfg.vocab, (B,), generator=g)
    return make_decode_step(model, mesh=mesh)(
        params, caches, tok, torch.full((), 3, dtype=torch.int32))


def main(out):
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro.launch.dryrun import wire_bytes as ref_wire_bytes
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as S
    torch.set_num_threads(1)
    res = {"ring": {k: ref_wire_bytes(v[0]) for k, v in HLO_LINES.items()}}
    shapes = {"train": ShapeConfig(*TRAIN), "decode": ShapeConfig(*DECODE)}
    models = {arch: _reduced(arch) for arch in E2E_ARCHS}
    # a fake (1, 1) group: the collectives' counts by kind and the FLOPs
    mesh = D.fake_mesh((1, 1), ("data", "model"))
    flops = {}
    for arch, m in models.items():
        for kind, shape in shapes.items():
            r = D.lower_model(m, shape, mesh)
            res[f"fake/{arch}/{kind}"] = r["collectives"]["count"]
            flops[arch, kind] = r["flops"]
    # the last decode step's FLOPs under FlopCounterMode
    step, inputs, _ = D.plan(m, shapes["decode"], mesh)
    with FakeTensorMode(), FlopCounterMode(display=False) as fc:
        step(*inputs(D.fake_device()))
    res["flops"] = dict(meter=flops[arch, "decode"],
                        flop_counter_mode=fc.get_total_flops())
    # --ft: the train step's FLOPs under each FlexHyCA cost emulation
    m = models[E2E_ARCHS[0]]
    res["ft_flops"] = {"": flops[E2E_ARCHS[0], "train"]}
    for emu in ("two_pass", "fused"):
        res["ft_flops"][emu] = D.lower_model(dataclasses.replace(
            m, run=dataclasses.replace(m.run, ft_emu=emu)), shapes["train"],
            mesh)["flops"]
    # a fake (2, 2) mesh: the parameter gather's wire bytes in the step
    mesh = D.fake_mesh((2, 2), ("data", "model"))
    gather_tree = S.gather_tree

    def counted(*a, **kw):
        before = pctx.WIRE_BYTES["all_gather"]
        out = gather_tree(*a, **kw)
        counted.wire += pctx.WIRE_BYTES["all_gather"] - before
        return out
    S.gather_tree = counted
    for arch, m in models.items():
        counted.wire = 0.0
        D.lower_model(m, shapes["train"], mesh)
        res[f"gather/{arch}"] = dict(wire=counted.wire)
    S.gather_tree = gather_tree
    dist.destroy_process_group()
    # the same steps on a real one-rank gloo group
    mesh = make_local_mesh(device="cpu")
    for arch, m in models.items():
        for kind, shape in shapes.items():
            pctx.COLLECTIVES.clear()
            _real_step(m, shape, mesh)
            res[f"real/{arch}/{kind}"] = dict(sorted(
                pctx.COLLECTIVES.items()))
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)

if __name__ == "__main__":
    main(sys.argv[1])
