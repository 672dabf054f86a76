// Device code shared by the DLA kernels (fused_decode, protected_mm, qmatmul,
// fault_inject): the int8 GEMM core, the 24-bit saturation, the 8-bit
// window and the bit-flip epilogues.  Every kernel that includes this
// header is rebuilt when it changes: kernels/build.py hashes every header of
// this directory.
//
// mma_tile, the split-K tensor-core GEMM core (fused_decode, protected_mm,
// qmatmul).  A block owns a BM x BN output tile and one chunk [k0, k1) of
// K; the launch plan (kernels/plan.py::gemm_plan) picks the tile shape, the
// chunk and the number of chunks ("splits", gridDim.z, at most 8) so that
// a decode-shaped M still puts several blocks on every SM.  The K loop
// walks the chunk in steps of BK = 64 through a ring of STAGES
// shared-memory stages filled by 16-byte cp.async copies (zero-filled
// outside the matrix), so the next steps' loads are in flight while this
// step's products run.  The w tile arrives as it lies in memory, (k, n)
// with n contiguous, but an s8 mma wants B k-contiguous per column; each
// step therefore transposes it once in shared memory, 4x4 bytes per thread
// with __byte_perm, into [n][k] (the layout an s8 wgmma would also take).
// Fragments are 32-bit shared loads, and mma.sync.m16n8k32.s32.s8.s8.s32
// accumulates in int32 with no saturation (rows past M are zero at
// decode).  The row strides are padded by 16 bytes and the transpose's
// threads are laid out so that its reads, its writes and the fragment loads
// are free of bank conflicts.  Where a 16-byte copy is not possible (K or N
// not a multiple of 16, or a base not 16-byte aligned) the same stages are
// filled by masked byte loads instead: the vec_x / vec_w flags, decided by
// the launcher, choose per operand.
//
// The splits of one tile are one thread block cluster (launch_mma).  They
// add their partials in distributed shared memory (park, Slice), which
// needs no scratch in device memory, no memset and no atomics.  A kernel
// with a static t finishes its slice by quads of 4 columns (window_quads).
//
// Exactness.  Every partial sum and every total is an exact int32:
// |acc| <= 128 * 128 * K < 2^31 for K < 2^17 (the wrappers check it), so
// the chunks' integer sum equals the product's in any order.  The 24-bit
// saturation and the |acc| maxima are taken on the total, never on a
// partial: a partial beyond 2^23 may come back under it.
//
// flip8 and flip8x4, the bit-flip epilogue (protected_mm, fault_inject):
// one word, or four consecutive words of a row from 16-byte plane loads.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace dla {

namespace cg = cooperative_groups;

constexpr int kAccBits = 24;
constexpr int kOutBits = 8;
constexpr int kAccLo = -(1 << (kAccBits - 1));
constexpr int kAccHi = (1 << (kAccBits - 1)) - 1;
constexpr int kThreads = 256;

__device__ __forceinline__ int saturate24(int a) {
  return min(max(a, kAccLo), kAccHi);
}

// round-to-nearest 8-bit window [t+7 : t] of the accumulator, saturated;
// >> of a negative int is an arithmetic (floor) shift
__device__ __forceinline__ int trunc8(int acc, int t) {
  const int half = t > 0 ? 1 << (t - 1) : 0;
  return min(max((acc + half) >> t, -128), 127);
}

// the low 8 bits of u as two's complement
__device__ __forceinline__ int sext8(int u) {
  return (u & 0x80) ? u - 256 : u;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The bits of an 8-bit word that a fault may reach: b < open_bits(prot),
// the top prot bits being TMR-voted (immune).  8 - prot as int32 arithmetic
// wraps, as the reference's does: a negative prot exposes every bit, 8 or
// more none.
__device__ __forceinline__ int open_bits(int prot) {
  return (int)((unsigned)kOutBits - (unsigned)prot);
}

// Flip bit b of the 8-bit word u where plane b's word is below thresh, for
// the bits b < open_bits(prot).  The planes hold uint32 words and are
// compared unsigned; plane b of this output is at planes[b *
// plane_stride].  A protected bit's plane is not read.
__device__ __forceinline__ int flip8(int u, const uint32_t* __restrict__ planes,
                                     size_t plane_stride, uint32_t thresh,
                                     int prot) {
  const int open = open_bits(prot);
  int flips = 0;
#pragma unroll
  for (int b = 0; b < kOutBits; ++b)
    if (b < open && planes[b * plane_stride] < thresh) flips |= 1 << b;
  return u ^ flips;
}

// flip8 of four 8-bit words u[j], columns n .. n+3 of one row whose plane
// words start at offset o (16-byte aligned), with one 16-byte load per
// plane: lane j leaves its top prot[j] bits alone and takes its planes from
// stream p1 where second[j] (kTwo only), else from p0.  Plane b of a stream
// is read only where some lane that takes the stream has bit b open, and
// every such load is issued before the first comparison.
template <bool kTwo>
__device__ __forceinline__ void flip8x4(int (&u)[4], const int (&prot)[4],
                                        const bool (&second)[4],
                                        const uint32_t* __restrict__ p0,
                                        const uint32_t* __restrict__ p1,
                                        size_t o, size_t plane_stride,
                                        uint32_t thresh) {
  int open[4], open0 = 0, open1 = 0;   // the most open bits of each stream
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    open[j] = open_bits(prot[j]);
    if (kTwo && second[j])
      open1 = max(open1, open[j]);
    else
      open0 = max(open0, open[j]);
  }
  const uint4 none = make_uint4(~0u, ~0u, ~0u, ~0u);   // no word is below
  uint4 w[kOutBits];
#pragma unroll
  for (int b = 0; b < kOutBits; ++b) {
    const uint4 a = b < open0
        ? *reinterpret_cast<const uint4*>(p0 + b * plane_stride + o) : none;
    w[b] = a;
    if (kTwo) {
      const uint4 c = b < open1
          ? *reinterpret_cast<const uint4*>(p1 + b * plane_stride + o) : none;
      w[b] = make_uint4(second[0] ? c.x : a.x, second[1] ? c.y : a.y,
                        second[2] ? c.z : a.z, second[3] ? c.w : a.w);
    }
  }
#pragma unroll
  for (int b = 0; b < kOutBits; ++b) {
    const uint32_t wb[4] = {w[b].x, w[b].y, w[b].z, w[b].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (b < open[j] && wb[j] < thresh) u[j] ^= 1 << b;
  }
}

// one stream: every lane reads p0
__device__ __forceinline__ void flip8x4(int (&u)[4], const int (&prot)[4],
                                        const uint32_t* __restrict__ planes,
                                        size_t o, size_t plane_stride,
                                        uint32_t thresh) {
  const bool first[4] = {false, false, false, false};
  flip8x4<false>(u, prot, first, planes, nullptr, o, plane_stride, thresh);
}

// four 8-bit words, low byte first
__device__ __forceinline__ uint32_t pack4(const int (&u)[4]) {
  uint32_t packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) packed |= (uint32_t)(u[j] & 0xFF) << (8 * j);
  return packed;
}

// ------------------------------------------------- the split-K mma core --

constexpr int kBK = 64;     // K step of the pipeline: two m16n8k32 steps

// A block of WM x WN warps over a BM x BN tile; each warp owns a
// (BM / WM) x (BN / WN) sub-tile of MT x NT m16n8 accumulators.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct MmaCfg {
  static constexpr int BM = BM_, BN = BN_, BK = kBK, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  // bytes per row of: an x tile [BM][BK], a raw w tile [BK][BN], a
  // transposed w tile [BN][BK]; each padded by 16 (bank spread, cp.async
  // alignment)
  static constexpr int kRowA = BK + 16, kRowW = BN + 16, kRowT = BK + 16;
  static constexpr int kBytesA = BM * kRowA, kBytesW = BK * kRowW;
  static constexpr int kBytesT = BN * kRowT;
  // one stage: the x tile and one raw w tile per B operand
  __host__ __device__ static constexpr int stage_bytes(bool dual) {
    return kBytesA + (dual ? 2 : 1) * kBytesW;
  }
  __host__ __device__ static constexpr int smem_bytes(bool dual) {
    return STAGES * stage_bytes(dual) + (dual ? 2 : 1) * kBytesT;
  }
  static_assert(BK == 64, "transpose_w lays out 16 k-quads");
  static_assert(MT >= 1 && NT >= 1 && BN % 64 == 0, "tile shape");
  static_assert((BN * BK / 16) % kThreads == 0, "transpose work per thread");
};

// M <= 16 (decode): one m16 row tile, zero rows past M; 4 warps across 64
// columns.  M > 16 (prefill): 64 x 128, 8 warps of 32 x 32.
// kernels/plan.py::gemm_plan hands the launcher (bm, bn) of one of these.
using DecodeCfg = MmaCfg<16, 64, 1, 4, 4>;
using PrefillCfg = MmaCfg<64, 128, 2, 4, 3>;

extern __shared__ __align__(16) uint8_t smem[];

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The first n (<= 16, may be <= 0) bytes at p, zero beyond, as 16 bytes.
__device__ __forceinline__ uint4 load16_masked(const int8_t* p, int n) {
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < n) v[b >> 2] |= (uint32_t)(uint8_t)p[b] << (8 * (b & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// 16 bytes of a row into shared memory: a cp.async copy where `vec` (the
// row is 16-byte aligned and holds all or none of the 16 bytes), else
// masked byte loads.  `valid` is how many of the 16 bytes lie inside.
__device__ __forceinline__ void stage16(uint8_t* dst, const int8_t* base,
                                        size_t offset, int valid, bool vec) {
  if (vec)
    cp_async16(dst, valid > 0 ? base + offset : base, valid > 0 ? 16 : 0);
  else
    *reinterpret_cast<uint4*>(dst) =
        load16_masked(valid > 0 ? base + offset : base, valid);
}

// Stage `st` of the ring <- the x tile [m0, m0+BM) x [k, k+BK) and the w
// tiles [k, k+BK) x [n0, n0+BN), zero outside the matrix and past k_end.
template <class C, bool kDual>
__device__ __forceinline__ void load_stage(
    uint8_t* st, const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int8_t* __restrict__ w2, int M, int N, int K, int m0, int n0,
    int k, int k_end, bool vec_x, bool vec_w) {
  constexpr int CA = C::BK / 16, CW = C::BN / 16;
  for (int i = threadIdx.x; i < C::BM * CA; i += C::kThreads) {
    const int r = i / CA, kk = k + 16 * (i % CA);
    const int valid = m0 + r < M ? min(k_end - kk, 16) : 0;
    stage16(st + r * C::kRowA + 16 * (i % CA), x,
            (size_t)(m0 + r) * K + kk, valid, vec_x);
  }
  uint8_t* sw = st + C::kBytesA;
  for (int i = threadIdx.x; i < C::BK * CW; i += C::kThreads) {
    const int r = i / CW, n = n0 + 16 * (i % CW);
    const int valid = k + r < k_end ? min(N - n, 16) : 0;
    const size_t o = (size_t)(k + r) * N + n;
    const int d = r * C::kRowW + 16 * (i % CW);
    stage16(sw + d, w, o, valid, vec_w);
    if (kDual) stage16(sw + C::kBytesW + d, w2, o, valid, vec_w);
  }
}

// raw [BK][BN] (n contiguous) -> tr [BN][BK] (k contiguous): each thread
// moves 4x4 byte blocks (k-quad kq, column quad ng).  Lane l of warp-step c
// takes ng = (l & 15) + 16 (c >> 3) and kq = (l >> 4) + 2 ((l & 15) >> 1)
// + 2 (c & 7) mod 16: (kq mod 2, ng mod 16) and (ng mod 2, kq) are both
// distinct across a warp, which with the padded strides (raw rows and
// transposed columns both 16 mod 32 words per 4 rows) keeps the reads and
// the writes on 32 distinct banks.
template <class C>
__device__ __forceinline__ void transpose_w(const uint8_t* raw, uint8_t* tr) {
  const uint32_t* r32 = reinterpret_cast<const uint32_t*>(raw);
  uint32_t* t32 = reinterpret_cast<uint32_t*>(tr);
  constexpr int RW = C::kRowW / 4, TW = C::kRowT / 4, KQ = C::BK / 4;
#pragma unroll
  for (int it = 0; it < (C::BN / 4) * KQ / C::kThreads; ++it) {
    const int i = it * C::kThreads + threadIdx.x, c = i >> 5, l = i & 31;
    const int ng = (l & 15) + 16 * (c >> 3);
    const int kq = ((l >> 4) + 2 * ((l & 15) >> 1) + 2 * (c & 7)) & (KQ - 1);
    const uint32_t r0 = r32[(4 * kq + 0) * RW + ng];
    const uint32_t r1 = r32[(4 * kq + 1) * RW + ng];
    const uint32_t r2 = r32[(4 * kq + 2) * RW + ng];
    const uint32_t r3 = r32[(4 * kq + 3) * RW + ng];
    // byte j of r_i is w[4kq + i][4ng + j]; out_j gathers byte j of each
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
    const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    t32[(4 * ng + 0) * TW + kq] = __byte_perm(t0, t2, 0x5410);
    t32[(4 * ng + 1) * TW + kq] = __byte_perm(t0, t2, 0x7632);
    t32[(4 * ng + 2) * TW + kq] = __byte_perm(t1, t3, 0x5410);
    t32[(4 * ng + 3) * TW + kq] = __byte_perm(t1, t3, 0x7632);
  }
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 accumulate, no
// saturation (.satfinite is not asked for)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class C>
using Acc = int[C::MT][C::NT][4];

// Tile-relative row and column of accumulator element e of mma tile
// (mt, nt) of this thread (the m16n8 s32 fragment layout).
template <class C>
__device__ __forceinline__ int acc_row(int mt, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp / C::WN) * C::WTM + mt * 16 + (lane >> 2) + 8 * (e >> 1);
}
template <class C>
__device__ __forceinline__ int acc_col(int nt, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp % C::WN) * C::WTN + nt * 8 + 2 * (lane & 3) + (e & 1);
}

// The block's partial sums of x[m0:m0+BM, k0:k1] @ w[k0:k1, n0:n0+BN] (and
// of the same x against w2 when kDual), unsaturated, in the m16n8 fragment
// layout.  Rows >= M and columns >= N read as zero.  Needs
// C::smem_bytes(kDual) of dynamic shared memory.
template <class C, bool kDual>
__device__ __forceinline__ void mma_tile(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int8_t* __restrict__ w2, int M, int N, int K, int m0, int n0,
    int k0, int k1, bool vec_x, bool vec_w, Acc<C>& acc, Acc<C>& acc2) {
  constexpr int kStage = C::stage_bytes(kDual);
  uint8_t* tr = smem + C::STAGES * kStage;
  uint8_t* tr2 = tr + C::kBytesT;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = acc2[mt][nt][e] = 0;

  const int nk = k1 > k0 ? (k1 - k0 + C::BK - 1) / C::BK : 0;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk)
      load_stage<C, kDual>(smem + s * kStage, x, w, w2, M, N, K, m0, n0,
                           k0 + s * C::BK, k1, vec_x, vec_w);
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int wrow = acc_row<C>(0, 0) - g, wcol = acc_col<C>(0, 0) - 2 * tig;
  constexpr int AW = C::kRowA / 4, TW = C::kRowT / 4;

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<C::STAGES - 2>();   // step it has landed (this thread's)
    __syncthreads();                  // ... and every thread's; step it-1
                                      // is no longer read by anyone
    const int nxt = it + C::STAGES - 1;
    if (nxt < nk)
      load_stage<C, kDual>(smem + (nxt % C::STAGES) * kStage, x, w, w2, M, N,
                           K, m0, n0, k0 + nxt * C::BK, k1, vec_x, vec_w);
    cp_async_commit();
    const uint8_t* st = smem + (it % C::STAGES) * kStage;
    transpose_w<C>(st + C::kBytesA, tr);
    if (kDual) transpose_w<C>(st + C::kBytesA + C::kBytesW, tr2);
    __syncthreads();

    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(st);
    const uint32_t* t32 = reinterpret_cast<const uint32_t*>(tr);
    const uint32_t* u32 = reinterpret_cast<const uint32_t*>(tr2);
#pragma unroll
    for (int ks = 0; ks < C::BK / 32; ++ks) {
      const int q = 8 * ks + tig;
      uint32_t a[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        const int r = wrow + 16 * mt + g;
        a[mt][0] = a32[r * AW + q];
        a[mt][1] = a32[(r + 8) * AW + q];
        a[mt][2] = a32[r * AW + q + 4];
        a[mt][3] = a32[(r + 8) * AW + q + 4];
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int n = wcol + 8 * nt + g;
        const uint32_t b0 = t32[n * TW + q], b1 = t32[n * TW + q + 4];
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
        if (kDual) {
          const uint32_t d0 = u32[n * TW + q], d1 = u32[n * TW + q + 4];
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt)
            mma_s8(acc2[mt][nt], a[mt], d0, d1);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The split-K reduction, across a thread block cluster.  The `splits`
// blocks of one output tile form one cluster along z (launch_mma sets the
// cluster's shape).  park() leaves each block's partial sums in its own
// shared memory and waits at a cluster barrier.  Block r of the cluster
// then owns slice r of the tile: the elements i = index(j) = (j * splits +
// r) * kThreads + thread, j < kPer, below end (the tile's rows < M, a
// multiple of 32 elements, so i < end is uniform across a warp, and a
// warp's 32 elements are 32 consecutive columns of one row).  sum(i) adds
// element i over every block's shared memory (distributed shared memory,
// in rank order): the complete, unsaturated int32 total; sum4(r, q) adds
// the four elements at columns 4q .. 4q+3 of row r at once (a kernel that
// uses it numbers quads, not elements, with index()).  rows() is a buffer
// of BM ints that park() zeroes, free for the kernel.  done() is the
// second cluster barrier, which keeps every block's shared memory alive
// until the whole cluster has read it.  With one split the cluster is the
// block itself.
template <class C, bool kDual>
struct Slice {
  static constexpr int RP = C::BN + 4;   // padded row of a parked tile (ints)
  static constexpr int kPer = C::BM * C::BN / C::kThreads;
  static constexpr int kParked = C::BM * RP * (kDual ? 2 : 1);
  static_assert(C::smem_bytes(kDual) >= 4 * (kParked + C::BM),
                "the parked tiles and a row buffer fit in shared memory");
  int splits, rank, end;

  static __device__ int32_t* parked() {
    return reinterpret_cast<int32_t*>(smem);
  }
  static __device__ int32_t* rows() { return parked() + kParked; }
  __device__ int index(int j) const {
    return (j * splits + rank) * C::kThreads + threadIdx.x;
  }
  // element i's total; second: the second B operand's
  __device__ int sum(int i, bool second = false) const {
    const int o = (second ? C::BM * RP : 0) + i / C::BN * RP + i % C::BN;
    int total = 0;
    for (int p = 0; p < splits; ++p)
      total += cg::this_cluster().map_shared_rank(parked(), p)[o];
    return total;
  }
  // one 16-byte load from each block (a parked row is a multiple of 16
  // bytes)
  __device__ int4 sum4(int r, int q) const {
    const int o = r * RP + 4 * q;
    int4 total = make_int4(0, 0, 0, 0);
    for (int p = 0; p < splits; ++p) {
      const int4 v = *reinterpret_cast<const int4*>(
          cg::this_cluster().map_shared_rank(parked(), p) + o);
      total.x += v.x;
      total.y += v.y;
      total.z += v.z;
      total.w += v.w;
    }
    return total;
  }
  __device__ void done() const { cg::this_cluster().sync(); }
};

template <class C, bool kDual>
__device__ __forceinline__ Slice<C, kDual> park(const Acc<C>& acc,
                                                const Acc<C>& acc2, int M,
                                                int m0) {
  using S = Slice<C, kDual>;
  int32_t* part = S::parked();
  __syncthreads();                  // the pipeline's buffers are free
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = acc_row<C>(mt, e) * S::RP + acc_col<C>(nt, e);
        part[o] = acc[mt][nt][e];
        if (kDual) part[C::BM * S::RP + o] = acc2[mt][nt][e];
      }
  if (threadIdx.x < C::BM) S::rows()[threadIdx.x] = 0;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  return S{(int)cluster.num_blocks(), (int)cluster.block_rank(),
           min(C::BM, M - m0) * C::BN};
}

// The window step of a kernel with a static t, over this block's slice of
// the tile by quads of 4 columns of a row (quad q = sl.index(j) < end / 4
// is row q / (BN / 4), columns 4 (q % (BN / 4)) .. +3): f(r, c, u) with r
// the quad's row and c its first column in the tile, and u[e] the word of
// column c + e, its complete total saturated to 24 bits and windowed at t
// (trunc8: -128 .. 127).  One 16-byte load per block of the cluster
// (sum4).
template <class C, bool kDual, class F>
__device__ __forceinline__ void window_quads(const Slice<C, kDual>& sl, int t,
                                             F&& f) {
  constexpr int kQ = C::BN / 4;
#pragma unroll
  for (int j = 0; j < Slice<C, kDual>::kPer / 4; ++j) {
    const int q = sl.index(j);
    if (q >= sl.end / 4) break;
    const int4 tot = sl.sum4(q / kQ, q % kQ);
    int u[4] = {trunc8(saturate24(tot.x), t), trunc8(saturate24(tot.y), t),
                trunc8(saturate24(tot.z), t), trunc8(saturate24(tot.w), t)};
    f(q / kQ, 4 * (q % kQ), u);
  }
}

// ------------------------------------------------- host side of mma_tile --

// The most splits of K: the blocks of a tile form one cluster, and 8 is the
// cluster size every Hopper part supports.
constexpr int kMaxSplits = 8;

// The plan the launcher was given (kernels/plan.py::gemm_plan): its tile
// is one of the two configurations, its chunk a multiple of kBK, and its
// chunks cover [0, K) exactly once.
inline bool plan_ok(int M, int N, int K, int bm, int bn, int kc, int splits) {
  const bool cfg = (bm == DecodeCfg::BM && bn == DecodeCfg::BN) ||
                   (bm == PrefillCfg::BM && bn == PrefillCfg::BN);
  return cfg && M > 0 && N > 0 && K >= 0 && kc > 0 && kc % kBK == 0 &&
         splits >= 1 && splits <= kMaxSplits &&
         (long long)splits * kc >= K &&
         (splits == 1 || (long long)(splits - 1) * kc < K);
}

// 16-byte copies need 16-byte rows and a 16-byte-aligned base.
inline bool vec_ok(const void* p, int row_bytes) {
  return p == nullptr ||
         (row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0);
}

// Launch a kernel of the core: grid (N tiles, M tiles, splits), one cluster
// of `splits` blocks along z per tile, C::smem_bytes(kDual) of dynamic
// shared memory.  The kernel is opted into that shared memory (above 48 KB)
// and the largest carveout, so that several blocks fit on an SM, once per
// instance of this template: each kernel of the core has its own (C, kDual,
// parameter types).
template <class C, bool kDual, typename... Params, typename... Args>
cudaError_t launch_mma(void (*kernel)(Params...), int M, int N, int splits,
                       cudaStream_t stream, Args... args) {
  constexpr int bytes = C::smem_bytes(kDual);
  static const cudaError_t opt_in = [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  if (opt_in != cudaSuccess) return opt_in;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, splits);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace dla
