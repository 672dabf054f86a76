"""The port's parallel layer held to the reference's rules, with no process
spawned (the multi-rank runs: tests/test_torch_sharded.py).

  * ``param_spec`` / ``param_shardings(no_fsdp=)``, ``cache_shardings``
    (paged and dense) and ``batch_shardings`` equal the reference's, leaf
    by leaf, for every registered architecture's reduced and full trees,
    on the meshes (16, 16), (2, 16, 16) and (2, 2) (the reference on a jax
    AbstractMesh, the port on its own): the reference's full configs stack
    scanned segments (a leading None in each spec), the port keeps one
    dict per layer.  ``cache_shardings`` departs in one place: a dense
    k/v/ck/cv cache whose kv heads do not divide 'model' stays whole over
    it, where the reference splits its length (split-K attention);
  * ``serving_shardings`` cuts only the MoE experts, as
    ``param_shardings(no_fsdp=True)`` cuts them;
  * ``plan_rescale`` equals the reference's on a grid and keeps the
    invariants of tests/test_elastic_props.py (hypothesis);
  * ``quantize_grad`` is bitwise the reference's on seeded inputs;
  * ``fold_axis_index`` folds each mesh coordinate as ``jax.random.fold_in``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import ARCHS, get_config as jget_config
from repro.models import build as jbuild
from repro.parallel import compression as jcomp
from repro.parallel import sharding as JS
from repro.train import elastic as jelastic
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.core.faults import fold_axis_index, fold_stream
from repro_torch.models import build
from repro_torch.parallel import compression as tcomp
from repro_torch.parallel import sharding as S
from repro_torch.parallel.ctx import MeshCtx
from repro_torch.train import elastic as telastic

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _jmesh(sizes, names):
    try:  # jax >= 0.5: AbstractMesh(axis_sizes, axis_names)
        return JAbstractMesh(sizes, names)
    except TypeError:  # jax 0.4.x: AbstractMesh(((name, size), ...))
        return JAbstractMesh(tuple(zip(names, sizes)))


def _entry(e):
    """An entry as PartitionSpec compares it: a 1-tuple is its axis."""
    if isinstance(e, (list, tuple)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _spec(s):
    """A jax NamedSharding's spec or a port P as a tuple of entries, the
    trailing unsharded dims dropped."""
    spec = getattr(s, "spec", s)
    out = [_entry(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _jflat(tree):
    """{path names: leaf} of a jax tree."""
    return {tuple(str(k.key) for k in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _layer_map(cfg):
    """The reference's stacked (seg{si}, s{j}) of each port layer l{i}."""
    out, i = {}, 0
    for si, (pattern, n_rep) in enumerate(cfg.segments):
        for _ in range(n_rep):
            for j in range(len(pattern)):
                out[f"l{i}"] = (f"seg{si}", f"s{j}")
                i += 1
    return out


def _ref_name(path, cfg, stacked):
    """The reference's leaf path of a port leaf path, and whether the
    reference stacks it."""
    if not stacked:
        return path, False
    if path[0] == "layers":
        return _layer_map(cfg)[path[1]] + path[2:], True
    if path[0] == "enc_layers":
        return ("enc_blocks", "s0") + path[2:], True
    return path, False


def _compare(port_tree, ref_tree, port_specs, ref_specs, cfg, stacked,
             departs=None):
    """Every leaf's port spec equals the reference's; ``departs(path,
    leaf, want)`` gives the spec the port keeps instead, where it departs
    (None where it does not).  Returns the number of departures."""
    jref = _jflat(ref_specs)
    n = gone = 0
    for path, spec in S.paths(port_specs):
        rpath, st = _ref_name(tuple(path), cfg, stacked)
        want = _spec(jref[rpath])
        if st:
            assert want[:1] in ((), (None,)), (rpath, want)
            want = want[1:]
        other = departs and departs(path, S._lookup(port_tree, path), want)
        if other is not None:
            want, gone = other, gone + 1
        assert _spec(spec) == want, (path, _spec(spec), want)
        n += 1
    assert n == len(S.paths(port_tree))
    return gone


def _split_k(mesh):
    """The port's cache departure on ``mesh``: where a dense (B, C, KH, Dh)
    k/v/ck/cv cache's kv heads do not divide 'model' and the reference
    splits its length C over 'model', the port keeps it whole."""
    tp = mesh.shape["model"]

    def departs(path, leaf, want):
        if (path[-1] in ("k", "v", "ck", "cv") and leaf.dim() == 4
                and leaf.shape[2] % tp and len(want) > 1
                and want[1] == "model"):
            return _spec(S.P(want[0]))
        return None
    return departs


def _trees(arch, reduced):
    jcfg = jget_config(arch, reduced=reduced)
    tcfg = get_config(arch, reduced=reduced)
    jm, tm = jbuild(jcfg), build(tcfg)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tp = tm.init(torch.Generator(), device="meta")
    return jcfg, jm, tm, jp, tp


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_rules_equal_reference(arch, reduced, mesh):
    jcfg, _, _, jp, tp = _trees(arch, reduced)
    jmesh, tmesh = _jmesh(*MESHES[mesh]), S.AbstractMesh(*MESHES[mesh])
    stacked = not jcfg.unroll
    for no_fsdp in (False, True):
        _compare(tp, jp, S.param_shardings(tp, tmesh, no_fsdp=no_fsdp),
                 JS.param_shardings(jp, jmesh, no_fsdp=no_fsdp), jcfg,
                 stacked)
    # param_spec alone, on the reference's own path objects
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        names = tuple(str(k.key) for k in path)
        assert _spec(S.param_spec(names, leaf, tmesh)) == _spec(
            JS.param_spec(path, leaf, jmesh)), names


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_rules_equal_reference(arch, mesh):
    jcfg, jm, tm, _, _ = _trees(arch, True)
    jmesh, tmesh = _jmesh(*MESHES[mesh]), S.AbstractMesh(*MESHES[mesh])
    B, T = 32, 48
    gone, kv = 0, set()
    for paged in (None, (8, 17)):
        enc = 16 if jcfg.enc_dec else None
        jc = jax.eval_shape(lambda: jm.init_cache(B, T, paged=paged,
                                                  enc_len=enc))
        tc = tm.init_cache(B, T, device="meta", paged=paged, enc_len=enc)
        gone += _compare(tc, jc, S.cache_shardings(tc, tmesh),
                         JS.cache_shardings(jc, jmesh), jcfg, False,
                         departs=_split_k(tmesh))
        kv |= {x.shape[2] for p, x in S.paths(tc)
               if p[-1] in ("k", "v", "ck", "cv") and x.dim() == 4}
    # the departure shows where it applies: caches of attention whose kv
    # heads the axis does not divide (the multi-query models)
    assert (gone > 0) == any(h % tmesh.shape["model"] for h in kv), (gone,
                                                                      kv)
    for rows in (B, 6, 1):
        jb = {"tokens": jax.ShapeDtypeStruct((rows, T), jnp.int32),
              "frames": jax.ShapeDtypeStruct((rows, T, 8), jnp.float32)}
        tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
        jsh = JS.batch_shardings(jb, jmesh)
        for k, spec in S.batch_shardings(tb, tmesh).items():
            assert _spec(spec) == _spec(jsh[k]), (k, rows)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "h2o-danube-1.8b"])
def test_serving_layout_cuts_only_the_experts(arch):
    _, _, _, _, tp = _trees(arch, True)
    mesh = S.AbstractMesh((2, 2), ("data", "model"))
    full = S.param_shardings(tp, mesh, no_fsdp=True)
    cut = 0
    for path, spec in S.paths(S.serving_shardings(tp, mesh)):
        leaf = S._lookup(tp, path)
        if S.keep_experts(path, leaf):
            assert spec == S._lookup(full, path) and spec[0] == "model"
            cut += 1
        else:
            assert spec == S.P(), path
    assert (cut > 0) == (arch == "qwen3-moe-235b-a22b")


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = S.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    spec = S.P(("pod", "data"), "model")
    assert S.placements(m, spec) == (Shard(0), Shard(0), Shard(1))
    assert S.placements(m, S.P(None, None)) == (Replicate(),) * 3
    assert MeshCtx(m, dp=("pod", "data")).resolve("dp", None, "tp") == \
        S.P(("pod", "data"), None, "model")
    assert S.local_shape((64, 32), spec, m) == (2, 2)


class _MeshLike:
    def __init__(self, dp, model=1):
        self.shape = {"data": dp, "model": model}


def test_plan_rescale_equals_reference_on_grid():
    for old_dp in range(1, 17):
        for ax in (1, 2, 4):
            for surv in range(1, old_dp * ax + 1):
                want = jelastic.plan_rescale(_MeshLike(old_dp), surv, ax)
                got = telastic.plan_rescale(_MeshLike(old_dp), surv, ax)
                assert (got.old_dp, got.new_dp, got.grad_accum_scale,
                        got.changed) == (want.old_dp, want.new_dp,
                                         want.grad_accum_scale, want.changed)


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=200, deadline=None)
@given(old_dp=st.integers(1, 64), lost=st.integers(0, 63),
       model_axis=st.integers(1, 8))
def test_plan_invariants(old_dp, lost, model_axis):
    total = old_dp * model_axis
    surviving = max(total - lost, 1)
    plan = telastic.plan_rescale(_MeshLike(old_dp), surviving, model_axis)
    assert 1 <= plan.new_dp <= old_dp
    assert old_dp % plan.new_dp == 0
    assert plan.new_dp * plan.grad_accum_scale == old_dp
    if surviving >= model_axis:
        assert plan.new_dp * model_axis <= max(surviving, model_axis)
    again = telastic.plan_rescale(_MeshLike(plan.new_dp),
                                  plan.new_dp * model_axis, model_axis)
    assert again.new_dp == plan.new_dp and not again.changed
    assert again.grad_accum_scale == 1


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "feedback"])
def test_quantize_grad_equals_reference(ef):
    rng = np.random.default_rng(3)
    for shape in ((64, 64), (7, 33), (1000,)):
        g = (rng.standard_normal(shape) * rng.uniform(1e-3, 10)).astype(
            np.float32)
        e = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
        jq, js, je = jcomp.quantize_grad(jnp.asarray(g),
                                         jnp.asarray(e) if ef else None)
        tq, ts, te = tcomp.quantize_grad(torch.from_numpy(g),
                                         torch.from_numpy(e) if ef else None)
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.float32(js) == np.float32(ts.item())
        assert np.array_equal(np.asarray(je), te.numpy())


class _Coords:
    """A DeviceMesh stand-in: this rank's coordinate on each named dim."""

    def __init__(self, **coords):
        self.coords = coords

    def get_local_rank(self, name):
        return self.coords[name]


def test_fold_axis_index_equals_fold_in():
    base = jax.random.PRNGKey(42)
    tbase = prng.PRNGKey(42, "cpu")
    for d in range(3):
        for m in range(4):
            want = jax.random.fold_in(jax.random.fold_in(base, d), m)
            got = fold_axis_index(tbase, _Coords(data=d, model=m), "data",
                                  "model")
            assert np.array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy()), (d, m)
            assert torch.equal(got, fold_stream(tbase, d, m))
