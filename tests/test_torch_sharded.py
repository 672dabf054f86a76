"""The port's sharded paths on a 4-rank gloo process group on the CPU,
(data, model) = (2, 2), each held to the port's meshless run (which the
other test files hold to the reference).

The ranks are spawned once per module (``_results``: this file run as a
script, ``torch.multiprocessing.spawn`` over a ``file://`` store, each rank
at one thread); rank 0 records every check, and each test reads its own.
The mesh is (2, 2) as the reference's sharded tests choose theirs: tp = 2
divides the reduced configs' kv heads (2), heads (4) and experts (4), so
attention splits by heads and the MoE combine is a two-term sum; MoE
``capacity_factor`` is 8, since the capacity is per shard.  The contract
(tests/test_serve_sharded.py, tests/test_multidevice.py):

  * Engine (both loops) and Scheduler temperature-0 tokens bitwise the
    meshless ones, for danube and qwen3-moe, under crt3 and under crt1 at
    BER 3e-3 with weight faults; the Engine's scan for the other four
    families under crt3;
  * a paged Scheduler's pools equal on every dp rank, its caches shaped by
    cache_shardings;
  * a sharded clean and FAT train step within 1e-3 of the meshless step
    (the loss and every parameter), the state's shards in the
    state_shardings layout; and, so that a wrong gradient path shows, with
    no warmup (a first update of ~lr), the parameters, m, v and the clip
    norm each within STATE_RTOL of the meshless step's largest magnitude
    (Adam's first update is about sign(g), so a gradient off by a factor
    shows only in m, v and the norm);
  * the expert-parallel MoE loss within 2e-3;
  * compressed_psum's relative error < 0.02;
  * fold_axis_index: each rank's stream is what a host loop over
    fold_stream(key, d, m) gives;
  * an elastic loss of 2 of the 4 ranks: handle_device_loss restores the
    checkpoint onto the survivors' (1, 2) mesh with grad_accum x 2, and a
    step from there equals a meshless resume of the same checkpoint with
    grad_accum x 2 within 1e-3, and its parameters, m, v and clip norm
    within STATE_RTOL.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest

ARCHS = ("h2o-danube-1.8b", "qwen3-moe-235b-a22b")
# the other families through the Engine's scan under crt3: the SSD's state
# whole on every rank, the RG-LRU split by width, multi-query attention
# (recurrentgemma, paligemma) whole over 'model', cross-attention, patches
FAMILIES = ("mamba2-2.7b", "recurrentgemma-9b", "seamless-m4t-medium",
            "paligemma-3b")
POLICIES = ("crt3", "crt1wf")
TRAIN_TOL = 1e-3
# float32 sums of the dp halves against the whole batch's: the measured
# leaf-relative differences are 1.0e-7 (clean) and 2.0e-7 (FAT), 0 after the
# elastic resume; a wrong factor, or half the batch, moves m, v and the norm
# by tens of percent
STATE_RTOL = 1e-5
MOE_TOL = 2e-3
PSUM_TOL = 0.02


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded") / "results.json"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _check(results, name):
    assert name in results, sorted(results)
    r = results[name]
    assert r["ok"], r


@pytest.mark.parametrize("loop", ["python", "scan"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_sharded_bitwise(results, arch, policy, loop):
    _check(results, f"engine/{arch}/{policy}/{loop}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_sharded_families_bitwise(results, arch):
    _check(results, f"engine/{arch}")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_sharded_bitwise(results, arch, policy):
    _check(results, f"scheduler/{arch}/{policy}")


def test_paged_pools_replicated(results):
    _check(results, "pools")


@pytest.mark.parametrize("kind", ["clean", "fat"])
def test_sharded_train_step_matches_meshless(results, kind):
    _check(results, f"train/{kind}")


def test_moe_expert_parallel_loss(results):
    _check(results, "moe_loss")


def test_compressed_psum(results):
    _check(results, "psum")


def test_fold_axis_index_streams(results):
    _check(results, "fold_axis_index")


def test_elastic_remesh_resumes(results):
    _check(results, "elastic")


# ------------------------------------------------------------ the ranks ---
def _state_diff(a, b, gn_a, gn_b):
    """The largest absolute parameter difference of two train states, and
    the largest leaf-relative difference over params, m, v and the clip
    norm (each leaf's difference over its largest magnitude in ``a``)."""
    from repro_torch import tree
    dp = max(float((x - y).abs().max()) for x, y in zip(
        tree.leaves(a["params"]), tree.leaves(b["params"])))
    rel = abs(float(gn_a) - float(gn_b)) / abs(float(gn_a))
    for k in ("params", "m", "v"):
        for x, y in zip(tree.leaves(a[k]), tree.leaves(b[k])):
            d = float((x - y).abs().max())
            rel = max(rel, d / max(float(x.abs().max()), 1e-30))
    return dp, rel


def _load(arch):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = get_config(arch, reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    m = build(cfg)
    return cfg, m, m.init(torch.Generator().manual_seed(0), device="cpu")


def _policy(name):
    from repro_torch import ft
    if name == "crt1wf":
        return ft.get_policy("crt1", ber=3e-3, weight_faults=True)
    return name


def _serving(rank, mesh, rec):
    import torch
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Request, Scheduler, SchedulerConfig
    for arch in ARCHS:
        cfg, m, params = _load(arch)
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (4, 8), generator=g)}
        scfg = ServeConfig(max_new_tokens=6)
        for pol in POLICIES:
            ref = Engine(m, params, cfg=scfg, policy=_policy(pol),
                         loop="python").generate(batch, seed=3)
            for loop in ("python", "scan"):
                got = Engine(m, params, cfg=scfg, policy=_policy(pol),
                             loop=loop, mesh=mesh).generate(batch, seed=3)
                rec(f"engine/{arch}/{pol}/{loop}", torch.equal(ref, got),
                    ref=ref.tolist(), got=got.tolist())

        def reqs():
            return [Request(rid=i, tokens=torch.randint(
                0, cfg.vocab, (4 + i % 3,),
                generator=torch.Generator().manual_seed(20 + i)).tolist(),
                max_new_tokens=5) for i in range(6)]
        sc = SchedulerConfig(max_batch=4, buckets=(8,), max_new_tokens=6,
                             decode_chunk=3)
        for pol in POLICIES:
            # danube through the graphed chunk loop, qwen3-moe eagerly
            loop = "scan" if arch == ARCHS[0] else "python"
            ref = Scheduler(m, params, sc, policy=_policy(pol),
                            loop=loop).run(reqs())
            sched = Scheduler(m, params, sc, policy=_policy(pol), mesh=mesh,
                              loop=loop)
            got = sched.run(reqs())
            want = [ref[i].generated for i in range(6)]
            have = [got[i].generated for i in range(6)]
            rec(f"scheduler/{arch}/{pol}", want == have, ref=want, got=have)
            if arch == ARCHS[0] and pol == "crt3":
                _pools(mesh, m, sched, rec)
    for arch in FAMILIES:
        cfg, m, params = _load(arch)
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (4, 6), generator=g)}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = torch.randn(
                (4, cfg.n_frontend_tokens, cfg.d_model), generator=g)
        if cfg.enc_dec:
            batch["frames"] = torch.randn((4, 5, cfg.d_model), generator=g)
        scfg = ServeConfig(max_new_tokens=4)
        ref = Engine(m, params, cfg=scfg, policy="crt3").generate(batch,
                                                                  seed=3)
        got = Engine(m, params, cfg=scfg, policy="crt3",
                     mesh=mesh).generate(batch, seed=3)
        rec(f"engine/{arch}", torch.equal(ref, got), ref=ref.tolist(),
            got=got.tolist())


def _pools(mesh, m, sched, rec):
    """Every pool leaf is whole on its pool and block dims and equal on
    both dp ranks; every cache leaf has its cache_shardings shape."""
    import torch
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as S
    whole = m.init_cache(sched.cfg.max_batch, sched.capacity, device="meta",
                         paged=(sched.cfg.block_size, sched.n_blocks))
    specs = S.cache_shardings(whole, mesh)
    ctx = S.make_ctx(mesh)
    ok, pools = True, 0
    for path, spec in S.paths(specs):
        local = S._lookup(sched._caches, path)
        full = S._lookup(whole, path)
        ok &= tuple(local.shape) == S.local_shape(full.shape, spec, mesh)
        if path[-1] in ("k", "v"):
            ok &= spec[0] is None and spec[1] is None
            both = pctx.all_gather(ctx, local[None], 0, "dp")
            ok &= bool(torch.equal(both[0], both[1]))
            ok &= bool(both.abs().sum() > 0)
            pools += 1
    rec("pools", bool(ok and pools), pools=pools)


def _train(rank, mesh, rec):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as S
    from repro_torch.train import (init_state, make_train_step, shard_state,
                                   state_shardings, unshard_state)
    f32 = RunConfig(param_dtype="float32", compute_dtype="float32")
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    m = build(cfg, f32)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 64), generator=g)}

    def fresh():
        return init_state(m, torch.Generator().manual_seed(0), opt, "cpu")
    for kind, fat in (("clean", {}), ("fat", dict(policy="crt1",
                                                   ft_ber=3e-3))):
        s1, met1 = make_train_step(m, opt, **fat)(fresh(), batch)
        specs = state_shardings(fresh(), mesh)
        local = shard_state(fresh(), mesh)
        shapes_ok = all(
            tuple(x.shape) == S.local_shape(w.shape, sp, mesh)
            for (_, x), (_, w), (_, sp) in zip(
                S.paths(local), S.paths(fresh()), S.paths(specs)))
        s2, met2 = make_train_step(m, opt, mesh=mesh, **fat)(local, batch)
        s2 = unshard_state(s2, specs, mesh)
        dl = abs(float(met1["loss"]) - float(met2["loss"]))
        dp, rel = _state_diff(s1, s2, met1["grad_norm"], met2["grad_norm"])
        rec(f"train/{kind}", dl < TRAIN_TOL and dp < TRAIN_TOL
            and rel < STATE_RTOL and shapes_ok, loss_diff=dl, param_diff=dp,
            state_rel_diff=rel, shapes_ok=shapes_ok)

    # the MoE's expert-parallel loss: each rank its dp rows and its experts
    cfg = get_config("qwen3-moe-235b-a22b", reduced=True)
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    m = build(cfg, f32)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    b = {"tokens": torch.randint(0, cfg.vocab, (8, 16),
                                 generator=torch.Generator().manual_seed(1))}
    with torch.no_grad():
        l0, _ = m.loss(params, b)
        ctx = S.make_ctx(mesh).for_rows(b["tokens"].shape[0])
        specs = S.param_shardings(params, mesh)
        local = S.distribute(params, specs, mesh)
        with pctx.mesh_ctx(ctx):
            l1, _ = m.loss(S.gather_tree(local, specs, mesh,
                                         keep=S.keep_experts),
                           {"tokens": pctx.local_rows(b["tokens"])})
        l1 = pctx.all_reduce(ctx, l1, "dp") / ctx.dp_size
    rec("moe_loss", abs(float(l0) - float(l1)) < MOE_TOL, l0=float(l0),
        l1=float(l1))


def _streams(rank, mesh, rec):
    import torch
    from repro_torch.core import prng
    from repro_torch.core.faults import fold_axis_index, fold_stream
    from repro_torch.parallel import ctx as pctx
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.compression import compressed_psum_test
    err = compressed_psum_test(0)
    rec("psum", err < PSUM_TOL, err=err)
    base = prng.PRNGKey(42, "cpu")
    mine = prng.uniform(fold_axis_index(base, mesh, "data", "model"), (4,))
    ctx = S.make_ctx(mesh)
    every = pctx.all_gather(ctx, pctx.all_gather(ctx, mine[None, None], 1,
                                                 "model"), 0, "data")
    want = torch.stack([torch.stack([prng.uniform(fold_stream(base, d, t),
                                                  (4,)) for t in range(2)])
                        for d in range(2)])
    rec("fold_axis_index", torch.equal(every, want))


def _elastic(rank, mesh, rec, tmp):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, unshard_state
    from repro_torch.train.elastic import simulate_device_loss
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    m = build(cfg, RunConfig(param_dtype="float32", compute_dtype="float32"))
    shape = ShapeConfig("tiny", "train", 64, 8)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    ck = os.path.join(tmp, "el")
    tc = TrainerConfig(total_steps=2, ckpt_every=2, log_every=1000,
                       ckpt_dir=ck, ckpt_async=False)
    tr = Trainer(m, shape, opt, tc, mesh=mesh, device="cpu")
    tr.run()
    torch.distributed.barrier()
    if rank == 0:
        shutil.copytree(ck, os.path.join(tmp, "ref"))
    torch.distributed.barrier()
    state, step = tr.handle_device_loss(simulate_device_loss(mesh, 2))
    if state is None:                 # a lost rank leaves
        return
    ok = (step == 2 and tr.model.run.grad_accum == 2
          and dict(zip(tr.mesh.mesh_dim_names, tr.mesh.mesh.shape))
          == {"data": 1, "model": 2})
    tr.cfg.total_steps = 3
    s_el, end = tr.run(state, step)
    s_el = unshard_state(s_el, tr.specs, tr.mesh)
    if rank != 0:
        return
    m2 = dataclasses.replace(m, run=dataclasses.replace(m.run, grad_accum=2))
    ref = Trainer(m2, shape, opt, dataclasses.replace(
        tc, total_steps=3, ckpt_dir=os.path.join(tmp, "ref")), device="cpu")
    s_ref, end_ref = ref.run()
    dl = abs(ref.metrics_log[-1]["loss"] - tr.metrics_log[-1]["loss"])
    dp, rel = _state_diff(s_ref, s_el, ref.metrics_log[-1]["grad_norm"],
                          tr.metrics_log[-1]["grad_norm"])
    rec("elastic", ok and end == end_ref == 3 and dl < TRAIN_TOL
        and dp < TRAIN_TOL and rel < STATE_RTOL, loss_diff=dl,
        param_diff=dp, state_rel_diff=rel)


def _rank(rank, store, out, tmp):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    found = {}

    def rec(name, ok, **detail):
        found[name] = dict(ok=bool(ok), **detail)
    for part in (_serving, _train, _streams):
        part(rank, mesh, rec)
    _elastic(rank, mesh, rec, tmp)
    dist.barrier()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(found, f)
    dist.destroy_process_group()


def main(out):
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="sharded_")
    try:
        mp.spawn(_rank, args=(os.path.join(tmp, "store"), out, tmp),
                 nprocs=4)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1])
