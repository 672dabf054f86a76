"""Launch plan of the split-K tensor-core GEMM core (``dla::mma_tile`` in
``kernels/csrc/dla.cuh``), shared by ``fused_decode``, ``protected_mm`` and
``qmatmul``.

The plan is plain integer arithmetic so that the CPU tests can hold it: it
picks the block tile and cuts K into ``splits`` chunks of ``kc`` (a
multiple of the pipeline's step ``BK``), enough that a decode-shaped M still
puts several blocks on every SM.  The blocks of one output tile form a
thread block cluster, which sums the chunks' int32 partials in distributed
shared memory; every sum stays below 2**31, so the total, saturated only
afterwards, is exact whatever the chunks.  ``k_chunks`` lists the chunks.
The CUDA launcher checks that a plan it is given is one of these.
"""
from __future__ import annotations

from typing import NamedTuple

BK = 64
# (bm, bn) of the core's two block tiles: one 16-row tile at decode-shaped M
# (rows past M are zero), 64 x 128 above it
DECODE_TILE = (16, 64)
PREFILL_TILE = (64, 128)
DECODE_M = 16
# blocks a plan aims for, per SM: decode streams w once and needs many
# loads in flight; prefill's 64 x 128 tiles are many already, and every
# split adds a cluster reduction of a 32-KB tile
DECODE_BLOCKS_PER_SM = 4
PREFILL_BLOCKS_PER_SM = 1
H100_SMS = 132
# the blocks of a tile form one cluster: at most 8, the portable cluster size
MAX_SPLITS = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GemmPlan(NamedTuple):
    bm: int
    bn: int
    kc: int
    splits: int

    def k_chunks(self, k: int):
        """[(k0, k1)] of each split, in order; they cover [0, k) once."""
        return [(s * self.kc, min((s + 1) * self.kc, k))
                for s in range(self.splits)]


def gemm_plan(m: int, k: int, n: int, sms: int = H100_SMS) -> GemmPlan:
    """The plan for an (m, k) x (k, n) product on a card with ``sms`` SMs:
    as many K chunks as bring the blocks to the target per SM, at most
    ``MAX_SPLITS``, each chunk at least two pipeline steps deep (one when K
    is shorter)."""
    decode = m <= DECODE_M
    bm, bn = DECODE_TILE if decode else PREFILL_TILE
    want = sms * (DECODE_BLOCKS_PER_SM if decode else PREFILL_BLOCKS_PER_SM)
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    k_steps = max(_cdiv(k, BK), 1)
    splits = max(min(_cdiv(want, tiles), k_steps // 2, MAX_SPLITS), 1)
    kc = _cdiv(k_steps, splits) * BK
    return GemmPlan(bm, bn, kc, max(_cdiv(k, kc), 1))
