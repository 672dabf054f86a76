// Device code shared by the DLA kernels (qmatmul, protected_mm, fault_inject):
// the int8 GEMM core, the 24-bit saturation, the static-t 8-bit window and the
// bit-flip epilogue.  Every kernel that includes this header is rebuilt when
// it changes: kernels/build.py hashes every header of this directory.
//
// The GEMM core is the tiled dp4a GEMM of fused_decode.cu: a 16x16 thread
// grid, each thread TM rows x 4 columns (rows ty + 16 i, columns tx + 16 j) of
// a (16 TM) x 64 output tile, K walked inside the block in steps of 32 with
// int8 tiles of x and w staged in shared memory (w transposed so that four
// consecutive k of one column form one 32-bit word).  Accumulation is exact
// in int32: |acc| <= 128 * 128 * K < 2^31 for K < 2^17, which the wrappers
// check.  A column tx + 16 j of the tile is consecutive across the 16
// threads of a half warp, so the epilogues' reads of planes and writes of
// outputs are 64-byte runs.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dla {

constexpr int kAccBits = 24;
constexpr int kOutBits = 8;
constexpr int kAccLo = -(1 << (kAccBits - 1));
constexpr int kAccHi = (1 << (kAccBits - 1)) - 1;
constexpr int kThreads = 256;
constexpr int kTileN = 64;

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

// Flip bit b of the 8-bit word u where plane b's word is below thresh, for
// the bits b < 8 - prot (the top prot bits are TMR-voted, immune).  The
// planes hold uint32 words and are compared unsigned; plane b of this
// output is at planes[b * plane_stride].  A protected bit's plane is not
// read.
__device__ __forceinline__ int flip8(int u, const uint32_t* __restrict__ planes,
                                     size_t plane_stride, uint32_t thresh,
                                     int prot) {
  int flips = 0;
#pragma unroll
  for (int b = 0; b < kOutBits; ++b)
    if (b < kOutBits - prot && planes[b * plane_stride] < thresh)
      flips |= 1 << b;
  return u ^ flips;
}

// The block's (16 TM) x 64 output tile at (m0, n0): each thread's TM x 4
// int32 accumulators over all of K, unsaturated.  Rows m >= M and columns
// n >= N read as zero.
template <int TM>
__device__ __forceinline__ void gemm_tile(const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ w,
                                          int M, int N, int K, int m0, int n0,
                                          int (&acc)[TM][4]) {
  constexpr int BM = 16 * TM, BN = kTileN, BK = 32, KQ = BK / 4;
  __shared__ int32_t xs[BM][KQ + 1];
  __shared__ int32_t ws[BN][KQ + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * KQ; i += kThreads) {
      const int r = i / KQ, q = i % KQ, m = m0 + r, k = k0 + 4 * q;
      uint32_t v = 0;
      if (m < M) {
        const int8_t* p = x + (size_t)m * K + k;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k + b < K) v |= (uint32_t)(uint8_t)p[b] << (8 * b);
      }
      xs[r][q] = (int32_t)v;
    }
    for (int i = tid; i < BN * KQ; i += kThreads) {
      const int c = i % BN, q = i / BN, n = n0 + c, k = k0 + 4 * q;
      uint32_t v = 0;
      if (n < N) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k + b < K)
            v |= (uint32_t)(uint8_t)w[(size_t)(k + b) * N + n] << (8 * b);
      }
      ws[c][q] = (int32_t)v;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      int a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + 16 * i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][q];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Launch geometry of a GEMM kernel: a 16-row tile (TM = 1) for decode-shaped
// M, 64 rows (TM = 4) above it.
inline bool small_m(int M) { return M <= 16; }

inline dim3 gemm_grid(int M, int N) {
  const int bm = small_m(M) ? 16 : 64;
  return dim3((N + kTileN - 1) / kTileN, (M + bm - 1) / bm);
}

}  // namespace dla
