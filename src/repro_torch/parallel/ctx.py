"""Mesh context: logical-axis resolution for model code, and the
collectives of the port's hand-built partitioning.

Counterpart of ``repro.parallel.ctx``.  Model code never names physical
mesh axes; it uses logical names:

  "dp"   batch/data-parallel axes (('pod', 'data') multi-pod, ('data',) else)
  "tp"   the tensor-parallel axis ('model')
  "fsdp" the weight-sharding axes (the dp axes)

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(or, for the sharding rules alone, a ``sharding.AbstractMesh``).  Without a
context model code runs its meshless path.

The reference gets its partitioning from GSPMD; here each rank runs the
model on its own block and the layout changes are explicit:

  * a rank's activations are its dp rows (when the caller split the batch:
    ``MeshCtx.rows``), whole on every other dim, so the residual stream is
    replicated over 'model';
  * ``ac(x, *logical)`` cuts this rank's block out of each dim named "tp"
    (a dim the axis does not divide stays whole, the reference's fallback);
    a "dp" entry states the rows are already this rank's and moves nothing;
  * ``gather(x, dim, "tp")`` is its inverse, ``psum`` the cross-rank sum of
    partial results (the MoE combine), ``gather_rows`` / ``local_rows`` move
    a batch between its dp blocks and the whole.

Each of them is a ``torch.autograd.Function`` whose backward is the
collective a replicated consumer needs (a cut's backward gathers, a
gather's backward cuts, ``psum``'s is the identity and ``tp_copy``'s sums),
so a train step differentiates through the partitioning.  Every collective
runs on the mesh dim's process group whatever its size: a one-rank mesh
launches the same collectives (``COLLECTIVES`` counts them by kind, and
``WIRE_BYTES`` adds up each one's per-device wire bytes, ``wire_bytes``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math

import torch

COLLECTIVES: collections.Counter = collections.Counter()
WIRE_BYTES: collections.Counter = collections.Counter()
# all_gather_single is all_gather_into_tensor's newer name
_all_gather_single = getattr(torch.distributed, "all_gather_single",
                             None) or torch.distributed.all_gather_into_tensor


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an AbstractMesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: object
    dp: tuple[str, ...] = ("data",)
    tp: str = "model"
    rows: bool = False   # this call's batch rows are split over the dp axes

    @property
    def dp_size(self) -> int:
        sh = mesh_shape(self.mesh)
        return int(math.prod(sh[a] for a in self.dp))

    @property
    def tp_size(self) -> int:
        return int(mesh_shape(self.mesh)[self.tp])

    def resolve(self, *logical):
        """Map logical axis names to a partition spec (``sharding.P``)."""
        from repro_torch.parallel.sharding import P
        out = []
        for ax in logical:
            if ax is None:
                out.append(None)
            elif ax == "dp":
                out.append(self.dp if len(self.dp) > 1 else self.dp[0])
            elif ax == "tp":
                out.append(self.tp)
            else:
                raise ValueError(f"unknown logical axis {ax!r}")
        return P(*out)

    def sharding(self, *logical):
        """DTensor placements, one per mesh dim, of the logical spec."""
        from repro_torch.parallel.sharding import placements
        return placements(self.mesh, self.resolve(*logical))

    def for_rows(self, n: int) -> "MeshCtx":
        """This context for a batch of ``n`` rows: split over the dp axes
        where they divide it (the reference's ``batch_shardings`` rule)."""
        return dataclasses.replace(self, rows=n % self.dp_size == 0)

    # ------------------------------------------------------ coordinates ---
    def coord(self, axis: str) -> int:
        return int(self.mesh.get_local_rank(axis))

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def dp_coord(self) -> int:
        """This rank's flat index over the dp axes (outer axis first)."""
        idx = 0
        sh = mesh_shape(self.mesh)
        for a in self.dp:
            idx = idx * sh[a] + self.coord(a)
        return idx


_CTX: list[MeshCtx | None] = [None]


def get_ctx() -> MeshCtx | None:
    return _CTX[0]


def set_ctx(ctx: MeshCtx | None):
    _CTX[0] = ctx


@contextlib.contextmanager
def mesh_ctx(ctx: MeshCtx | None):
    prev = _CTX[0]
    _CTX[0] = ctx
    try:
        yield ctx
    finally:
        _CTX[0] = prev


# ----------------------------------------------------------- collectives ---
def wire_bytes(kind: str, out_bytes: int, group: int) -> float:
    """Per-device bytes a ring algorithm moves for one collective of
    ``kind`` (the two the port issues) with ``out_bytes`` of output over a
    group of ``group`` ranks (the reference dry run's formulas)."""
    g = max(group, 1)
    if kind == "all_gather":
        return out_bytes * (g - 1) / g
    if kind == "all_reduce":
        return 2 * out_bytes * (g - 1) / g
    raise ValueError(f"unknown collective {kind!r}")


def _count(kind: str, out, group: int) -> None:
    COLLECTIVES[kind] += 1
    WIRE_BYTES[kind] += wire_bytes(kind, out.numel() * out.element_size(),
                                   group)


def _axes(ctx: MeshCtx, axes) -> tuple:
    if axes == "tp":
        return (ctx.tp,)
    if axes == "dp":
        return ctx.dp
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _size(ctx, axes) -> int:
    sh = mesh_shape(ctx.mesh)
    return int(math.prod(sh[a] for a in _axes(ctx, axes)))


def all_gather(ctx, x, dim: int, axes):
    """Concatenate every rank's ``x`` along ``dim`` over ``axes`` (several
    axes gather innermost first, so blocks land in flat-index order); the
    result is contiguous, as a kernel operand must be."""
    for a in reversed(_axes(ctx, axes)):
        n = mesh_shape(ctx.mesh)[a]
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
        _all_gather_single(out, xm, group=ctx.group(a))
        _count("all_gather", out, n)
        x = out.movedim(0, dim).contiguous()
    return x


def all_reduce(ctx, x, axes, op=None):
    """Sum (or ``op``) of ``x`` over ``axes``, out of place."""
    x = x.contiguous().clone()
    for a in reversed(_axes(ctx, axes)):
        torch.distributed.all_reduce(
            x, op=op or torch.distributed.ReduceOp.SUM, group=ctx.group(a))
        _count("all_reduce", x, mesh_shape(ctx.mesh)[a])
    return x


def block(ctx, x, dim: int, axes):
    """This rank's block of ``x`` along ``dim`` over ``axes``."""
    n = _size(ctx, axes)
    idx = 0
    for a in _axes(ctx, axes):
        idx = idx * mesh_shape(ctx.mesh)[a] + ctx.coord(a)
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, dim, axes):
        fctx.args = (ctx, dim, axes)
        return all_gather(ctx, x, dim, axes)

    @staticmethod
    def backward(fctx, g):
        ctx, dim, axes = fctx.args
        return block(ctx, g, dim, axes), None, None, None


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, dim, axes):
        fctx.args = (ctx, dim, axes)
        return block(ctx, x, dim, axes).contiguous()

    @staticmethod
    def backward(fctx, g):
        ctx, dim, axes = fctx.args
        return all_gather(ctx, g, dim, axes), None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        return all_reduce(ctx, x, axes)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.args = (ctx, axes)
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return all_reduce(fctx.args[0], g, fctx.args[1]), None, None


def gather(x, dim: int, axes, ctx: MeshCtx | None = None):
    """All ranks' blocks of ``x`` along ``dim`` over ``axes`` ("tp", "dp" or
    axis names), whole; the backward keeps this rank's block of the
    gradient (the consumer is replicated)."""
    ctx = ctx or get_ctx()
    return _Gather.apply(x, ctx, dim, axes)


def cut(x, dim: int, axes, ctx: MeshCtx | None = None):
    """This rank's block of a replicated ``x``; the backward gathers."""
    ctx = ctx or get_ctx()
    return _Cut.apply(x, ctx, dim, axes)


def psum(x, axes="tp", ctx: MeshCtx | None = None):
    """Sum of every rank's partial ``x`` (backward: the identity)."""
    ctx = ctx or get_ctx()
    return _Sum.apply(x, ctx, axes)


def tp_copy(x, axes="tp", ctx: MeshCtx | None = None):
    """``x`` unchanged into a region where each rank computes a different
    part from it; the backward sums the parts' gradients."""
    ctx = ctx or get_ctx()
    return _Copy.apply(x, ctx, axes)


def gather_rows(x, ctx: MeshCtx | None = None):
    """The whole batch from each rank's dp rows (dim 0), where the rows are
    split; ``x`` itself otherwise."""
    ctx = ctx or get_ctx()
    if ctx is None or not ctx.rows:
        return x
    return gather(x, 0, "dp", ctx)


def local_rows(x, ctx: MeshCtx | None = None):
    """This rank's dp rows of a whole batch (dim 0), where the rows are
    split; ``x`` itself otherwise."""
    ctx = ctx or get_ctx()
    if ctx is None or not ctx.rows:
        return x
    return block(ctx, x, 0, "dp")


def ac(x, *logical):
    """Activation layout constraint (no-op without a mesh context): this
    rank's block of every dim named "tp" that the axis divides, the others
    whole; "dp" entries move nothing (the rows are already the rank's)."""
    ctx = get_ctx()
    if ctx is None:
        return x
    for dim, ax in enumerate(logical):
        if ax == "tp" and x.shape[dim] % ctx.tp_size == 0:
            x = cut(x, dim, "tp", ctx)
    return x


def ag(x, dim: int, full: int):
    """The inverse of ``ac`` on one dim whose whole size is ``full``: the
    blocks gathered over 'tp' where ``ac`` cut them (no-op without a mesh
    context)."""
    ctx = get_ctx()
    if ctx is None or full % ctx.tp_size:
        return x
    return gather(x, dim, "tp", ctx)
