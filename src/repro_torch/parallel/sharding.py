"""Parameter / batch / cache partition rules, and the moves between whole
tensors and each rank's shards.

Counterpart of ``repro.parallel.sharding``, with the same rule tables: every
weight is sharded 2-D, the tensor-parallel dim over 'model' and an FSDP dim
over the data axes (('pod', 'data') on the multi-pod mesh).  Dims that do
not divide the axis size are left unsharded (replicated), e.g. seamless'
vocab 256206 on a 16-way axis.  A path is a tuple of the tree's dict keys;
a spec is a ``P`` (one entry per tensor dim: None, an axis name or a tuple
of them), which ``placements`` turns into DTensor placements.

The rules take any mesh with axis names and sizes: a ``DeviceMesh``, or an
``AbstractMesh`` (no devices, no process group) for the production shapes
(16, 16) and (2, 16, 16).  ``distribute`` cuts whole tensors into this
rank's shards (the local tensors of ``torch.distributed.tensor.
distribute_tensor`` with these placements, cut on each rank from its own
whole copy, so no collective runs); ``gather_tree`` puts the whole tensors
back together with ``all_gather`` over each sharded dim.
"""
from __future__ import annotations

import math

from repro_torch import tree
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel.ctx import MeshCtx, mesh_shape


class P(tuple):
    """A partition spec: one entry per tensor dim (trailing dims missing
    from it are replicated); equal to a tuple of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class AbstractMesh:
    """Axis names and sizes only: enough for the rules."""

    def __init__(self, sizes, names):
        self.shape = dict(zip(names, sizes))


def check_model(cfg, mesh) -> None:
    """Raise where the port cannot split ``cfg``'s layers over ``mesh``'s
    'model' axis bit for bit: the RG-LRU splits its width by heads."""
    from repro_torch.models.transformer import layer_kinds
    tp = mesh_shape(mesh)["model"]
    kinds = set(layer_kinds(cfg))
    if "R" in kinds and max(cfg.n_heads, 1) % tp:
        raise ValueError(f"{cfg.n_heads} RG-LRU heads do not split over a "
                         f"{tp}-way 'model' axis")


def make_ctx(mesh) -> MeshCtx:
    names = mesh_shape(mesh)
    if "model" not in names:
        raise ValueError(f"a mesh needs a 'model' axis; this one has "
                         f"{tuple(names)}")
    dp = tuple(a for a in ("pod", "data") if a in names)
    return MeshCtx(mesh=mesh, dp=dp, tp="model")


def _axsize(mesh, axes) -> int:
    sh = mesh_shape(mesh)
    if isinstance(axes, str):
        return sh[axes]
    return int(math.prod(sh[a] for a in axes))


def _maybe(mesh, dim: int, axes):
    """Shard `dim` over `axes` only when it divides evenly."""
    if axes is None or dim % _axsize(mesh, axes) != 0:
        return None
    return axes if isinstance(axes, str) else tuple(axes)


# rule tables: name -> (spec builder over unstacked dims)
_IN_PROJ = {"wq", "wk", "wv", "wi", "wg", "in_proj", "w_x", "w_gate"}
_OUT_PROJ = {"wo", "out_proj", "w_out"}
_SQUARE = {"w_a", "w_i"}


def _fsdp(mesh) -> tuple:
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def param_spec(path, leaf, mesh) -> P:
    names = [str(k) for k in path]
    name = names[-1]
    stacked = names[0].startswith("seg") or names[0] == "enc_blocks"
    fsdp = _fsdp(mesh)
    tp = "model"
    shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
    nd = len(shape)

    def spec(*entries):
        entries = list(entries) + [None] * (nd - len(entries))
        if stacked:
            entries = [None] + entries
        return P(*entries)

    if name in ("embed", "unembed"):
        return spec(_maybe(mesh, shape[0], tp), _maybe(mesh, shape[1], fsdp))
    if name in _IN_PROJ and nd == 2:
        return spec(_maybe(mesh, shape[0], fsdp), _maybe(mesh, shape[1], tp))
    if name in _IN_PROJ and nd == 3:     # MoE experts (E, D, F)
        return spec(_maybe(mesh, shape[0], tp), _maybe(mesh, shape[1], fsdp))
    if name in _OUT_PROJ and nd == 2:
        return spec(_maybe(mesh, shape[0], tp), _maybe(mesh, shape[1], fsdp))
    if name in _OUT_PROJ and nd == 3:    # MoE experts (E, F, D)
        return spec(_maybe(mesh, shape[0], tp), _maybe(mesh, shape[1], fsdp))
    if name in _SQUARE:   # block-diagonal RG-LRU gates (heads, bw, bw)
        return spec(_maybe(mesh, shape[0], tp), None,
                    _maybe(mesh, shape[2], fsdp) if nd > 2 else None)
    if name == "conv_w":
        return spec(None, _maybe(mesh, shape[1], tp))
    return spec()  # norms, biases, scalars: replicated


def paths(t, path=()):
    """[(path, leaf)] of a nested dict, keys as given."""
    if isinstance(t, dict):
        return [pl for k in t for pl in paths(t[k], path + (k,))]
    return [(path, t)]


def _map_path(fn, t, path=()):
    if isinstance(t, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in t.items()}
    return fn(path, t)


def param_shardings(param_tree, mesh, no_fsdp: bool = False):
    """A spec per parameter.  ``no_fsdp``: the serving layout, weights
    sharded over 'model' only and replicated over the dp axes."""
    fsdp_names = set(_fsdp(mesh))

    def _clean(e):
        if e is None:
            return None
        if isinstance(e, tuple):
            return None if set(e) & fsdp_names else e
        return None if e in fsdp_names else e

    def one(p, x):
        spec = param_spec(p, x, mesh)
        if no_fsdp:
            spec = P(*[_clean(e) for e in spec])
        return spec
    return _map_path(one, param_tree)


def serving_shardings(param_tree, mesh):
    """The layout the Engine and the Scheduler hold: every leaf whole on
    every rank, as a protected projection computes on whole weights
    (``models.common.linear``), except a MoE layer's experts, cut over
    'model' as ``param_shardings(no_fsdp=True)`` cuts them (expert
    parallelism, ``models.moe``)."""
    specs = param_shardings(param_tree, mesh, no_fsdp=True)
    return _map_path(lambda p, x: _lookup(specs, p) if keep_experts(p, x)
                     else P(), param_tree)


def batch_shardings(batch_tree, mesh):
    """Batch dim over the dp axes (replicated if it doesn't divide)."""
    dp = _fsdp(mesh)

    def one(x):
        entry = _maybe(mesh, x.shape[0], dp)
        return P(*([entry] + [None] * (x.dim() - 1)))
    return tree.tree_map(one, batch_tree)


def cache_shardings(cache_tree, mesh, unrolled: bool = False):
    """KV/state caches: batch over dp, head/width dims over 'model' when they
    divide.  Cache layouts (a leading stack dim on 'seg*' trees unless
    unrolled): attn k/v (B, C, KH, Dh); rglru h (B, W), conv (B, K-1, W);
    ssd state (B, H, P, N), conv (B, K-1, C).

    Paged attention caches (a ``bt`` block table beside ``k``/``v``) store a
    *pool* ``(n_blocks, block_size, KH, Dh)``: block tables hold **global**
    block ids, so the pool dim (and the block dim) stay replicated over the
    dp axes.  Pools shard on kv heads over 'model' only; the table is
    per-slot state and shards with the batch.

    One departure from the reference's rule: where the kv heads do not
    divide 'model', a dense cache stays whole over it; the reference splits
    its length there (split-K attention, which is not bitwise), and the
    port's attention runs whole on every 'model' rank instead.
    """
    dp = _fsdp(mesh)
    pooled = {p[:-1] for p, _ in paths(cache_tree) if p[-1] == "bt"}

    def one(path, x):
        names = [str(k) for k in path]
        stacked = (not unrolled) and names[0].startswith("seg")
        shape = tuple(x.shape[1:] if stacked else x.shape)
        name = names[-1]
        paged = tuple(path[:-1]) in pooled
        if paged and name in ("k", "v"):
            # (n_blocks, block_size, KH, Dh): pool + block dims replicated
            entries = [None] * len(shape)
            if len(shape) == 4:
                entries[2] = _maybe(mesh, shape[2], "model")
        else:
            entries = [_maybe(mesh, shape[0], dp)] + [None] * (len(shape) - 1)
            if (not paged and name in ("k", "v", "ck", "cv")
                    and len(shape) == 4):
                # (B, C, KH, Dh): kv heads over 'model'; where they don't
                # divide it, whole over 'model'
                entries[2] = _maybe(mesh, shape[2], "model")
            elif name == "state" and len(shape) == 4:
                entries[1] = _maybe(mesh, shape[1], "model")
            elif name in ("h",) and len(shape) == 2:
                entries[1] = _maybe(mesh, shape[1], "model")
            elif name == "conv" and len(shape) == 3:
                entries[2] = _maybe(mesh, shape[2], "model")
        if stacked:
            entries = [None] + entries
        return P(*entries)

    return _map_path(one, cache_tree)


def placements(mesh, spec):
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that shards tensor dim d, ``Replicate()`` elsewhere.  A tensor
    dim over several mesh dims is cut outer dim first, as ``block`` cuts
    it."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_shape(mesh):
        d = next((i for i, e in enumerate(spec)
                  if e == name or (isinstance(e, tuple) and name in e)), None)
        out.append(Replicate() if d is None else Shard(d))
    return tuple(out)


def _entries(spec):
    for dim, e in enumerate(spec):
        if e is not None:
            yield dim, ((e,) if isinstance(e, str) else tuple(e))


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for dim, axes in _entries(spec):
        out[dim] //= _axsize(mesh, axes)
    return tuple(out)


def distribute(tree_, shardings, mesh, keep=None):
    """This rank's shard of every leaf of ``tree_`` (whole tensors, the same
    on every rank) under ``shardings`` (a spec tree of the same structure):
    the local tensor ``distribute_tensor`` would give, cut without a
    collective.  ``keep(path, leaf)`` names axes a leaf is already cut on
    (``gather_tree``'s)."""
    ctx = make_ctx(mesh)

    def one(path, x):
        kept = keep(path, x) if keep is not None else ()
        for dim, axes in _entries(_lookup(shardings, path)):
            axes = tuple(a for a in axes if a not in kept)
            if axes:
                x = pctx.block(ctx, x, dim, axes)
        return x.contiguous()
    return _map_path(one, tree_)


def gather_tree(tree_, shardings, mesh, keep=None):
    """The whole tensors of a tree of shards: ``all_gather`` over every
    sharded dim, except the axes ``keep(path, leaf)`` names (a set of axis
    names, e.g. {'model'} for the MoE experts that stay on their rank)."""
    ctx = make_ctx(mesh)

    def one(path, x):
        spec = _lookup(shardings, path)
        kept = keep(path, x) if keep is not None else ()
        for dim, axes in _entries(spec):
            axes = tuple(a for a in axes if a not in kept)
            if axes:
                x = pctx.all_gather(ctx, x, dim, axes)
        return x
    return _map_path(one, tree_)


def _lookup(t, path):
    for k in path:
        t = t[k]
    return t


def keep_experts(path, leaf) -> set:
    """A MoE layer's (E, ., .) expert weights stay sharded over 'model'
    (expert parallelism, ``models.moe.apply``); every other leaf is
    computed with whole."""
    expert = leaf.dim() == 3 and str(path[-1]) in ("wi", "wg", "wo")
    return {"model"} if expert else set()
