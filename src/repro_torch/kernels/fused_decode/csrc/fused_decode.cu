// Fused inject -> protect -> qmatmul for Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/fused_decode/kernel.py::fused_decode, the Pallas
// TPU kernel that every protected projection of prefill and decode runs
// through (protect_linear(backend="fused")).  It computes, bit for bit:
//
//   1. optionally, per-row weight flips: row m multiplies by
//      sext8((w & 0xFF) ^ wflips[m]) instead of the shared w;
//   2. int8 x int8 products summed into an int32 accumulator;
//   3. saturation to 24 bits;
//   4. t = clip(bit_length(max|acc|) - 7, q_scale, 16), per row or global,
//      with q_scale read from device memory;
//   5. a round-to-nearest 8-bit window [t+7 : t];
//   6. XOR with the packed output flip words, then sign extension;
//   7. a DPPU recompute on a second accumulator (clean weights) or on the
//      same one, with its own flip words, selected on the important channels.
//
// Design.  The TPU kernel holds the whole (M, N) accumulator in VMEM and walks
// K in order.  Here blocks run in parallel and in no order, and at prefill M
// (batch x prompt) and N (up to 6912) do not fit one block, so M and N are
// tiled across blocks and t, which needs the max over a row or over the whole
// output, is found in a second launch:
//
//   launch 1 (GEMM): each block owns an output tile over all of K, staging
//     int8 tiles of x and w in shared memory (w transposed so that four
//     consecutive k of one column form one 32-bit word) and accumulating
//     with dp4a.  It saturates to 24 bits, writes the int32 accumulator to
//     scratch, and atomicMax-es |acc| into a per-row buffer.  With per-row
//     weight flips every row has its own B operand, so a thread owns one
//     (m, n) and builds the faulty weight on the fly from the shared weight
//     and the row's flip word as it walks K.
//   launch 2 (epilogue): one block per (row, 256 columns) reduces the row
//     buffer to t (its own row, or all rows for the global t), then
//     truncates, XORs, selects and sign-extends into int8.
//
// What bounds it.  At decode (M = batch = 4) the work is 2*M*K*N int8
// operations on K*N weight bytes: about 2 operations per byte, far below the
// card's ~590 int8 operations per byte of HBM traffic, so the bound is the
// bytes of w (and of the flip words) read once.  This first version does
// not reach it: there is no cp.async/TMA pipelining of the K loop and no
// tensor-core (mma/wgmma s8) path; it is written to be right and simple.
// Its measured time beside the bound is in PERF.md.
//
// Accumulation is exact in int32: |acc| <= 128 * 128 * K < 2^31 for
// K < 2^17, which the wrapper checks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAccBits = 24;
constexpr int kOutBits = 8;
constexpr int kAccLo = -(1 << (kAccBits - 1));
constexpr int kAccHi = (1 << (kAccBits - 1)) - 1;
constexpr int kThreads = 256;

__device__ __forceinline__ int saturate24(int a) {
  return min(max(a, kAccLo), kAccHi);
}

// the reference's _sign_extend: low 8 bits as two's complement
__device__ __forceinline__ int sext8(int u) {
  return (u & 0x80) ? u - 256 : u;
}

__device__ __forceinline__ int trunc8(int acc, int t) {
  const int half = t > 0 ? 1 << (t - 1) : 0;
  return min(max((acc + half) >> t, -128), 127);
}

__device__ __forceinline__ int half_warp_max(int v) {
  // lanes 0-15 and 16-31 reduce separately (offsets stay inside a half)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Shared-weight GEMM: a 16x16 thread grid, each thread TM rows x 4 columns
// (rows ty + 16 i, columns tx + 16 j), tile (16 TM) x 64 x 32.
template <int TM, bool kDual>
__global__ void __launch_bounds__(kThreads)
fused_decode_gemm_shared(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const int8_t* __restrict__ w2,
                         int32_t* __restrict__ acc_out,
                         int32_t* __restrict__ acc2_out,
                         int32_t* __restrict__ rowmax, int M, int N, int K) {
  constexpr int BM = 16 * TM, BN = 64, BK = 32, KQ = BK / 4;
  __shared__ int32_t xs[BM][KQ + 1];
  __shared__ int32_t ws[BN][KQ + 1];
  __shared__ int32_t ws2[kDual ? BN : 1][KQ + 1];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[TM][4], acc2[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0;

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
      uint32_t v = 0, v2 = 0;
      if (n < N) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (k + b < K) {
            const size_t o = (size_t)(k + b) * N + n;
            v |= (uint32_t)(uint8_t)w[o] << (8 * b);
            if (kDual) v2 |= (uint32_t)(uint8_t)w2[o] << (8 * b);
          }
        }
      }
      ws[c][q] = (int32_t)v;
      if (kDual) ws2[c][q] = (int32_t)v2;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      int a[TM], b[4], b2[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + 16 * i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = ws[tx + 16 * j][q];
        if (kDual) b2[j] = ws2[tx + 16 * j][q];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
          if (kDual) acc2[i][j] = __dp4a(a[i], b2[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    int rmax = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < M && n < N) {
        const size_t o = (size_t)m * N + n;
        const int s = saturate24(acc[i][j]);
        acc_out[o] = s;
        rmax = max(rmax, abs(s));
        if (kDual) acc2_out[o] = saturate24(acc2[i][j]);
      }
    }
    rmax = half_warp_max(rmax);
    if (tx == 0 && m < M) atomicMax(rowmax + m, rmax);
  }
}

// Per-row weight flips: thread (m, n) walks K with its own faulty weights.
template <bool kDual>
__global__ void __launch_bounds__(kThreads)
fused_decode_gemm_perrow(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const int8_t* __restrict__ w2,
                         const int32_t* __restrict__ wflips,
                         int32_t* __restrict__ acc_out,
                         int32_t* __restrict__ acc2_out,
                         int32_t* __restrict__ rowmax, int M, int N, int K) {
  const int m = blockIdx.x, n = blockIdx.y * kThreads + threadIdx.x;
  int a = 0, a2 = 0;
  if (n < N) {
    const int8_t* xr = x + (size_t)m * K;
    const int32_t* wf = wflips + (size_t)m * K * N + n;
    for (int k = 0; k < K; ++k) {
      const int xv = xr[k];
      const size_t o = (size_t)k * N + n;
      a += xv * sext8(((int)w[o] & 0xFF) ^ wf[(size_t)k * N]);
      if (kDual) a2 += xv * (int)w2[o];
    }
    const size_t o = (size_t)m * N + n;
    a = saturate24(a);
    acc_out[o] = a;
    if (kDual) acc2_out[o] = saturate24(a2);
  }
  const int rmax = warp_max(n < N ? abs(a) : 0);
  if ((threadIdx.x & 31) == 0) atomicMax(rowmax + m, rmax);
}

__global__ void __launch_bounds__(kThreads)
fused_decode_epilogue(const int32_t* __restrict__ acc,
                      const int32_t* __restrict__ acc_d,
                      const int32_t* __restrict__ rowmax,
                      const int32_t* __restrict__ oflips,
                      const int32_t* __restrict__ dflips,
                      const int32_t* __restrict__ imp,
                      const int32_t* __restrict__ q_scale,
                      int8_t* __restrict__ y, int32_t* __restrict__ t_out,
                      int M, int N, int per_row) {
  __shared__ int red[kThreads / 32];
  const int m = blockIdx.x;
  int amax;
  if (per_row) {
    amax = rowmax[m];
  } else {
    int v = 0;
    for (int i = threadIdx.x; i < M; i += kThreads) v = max(v, rowmax[i]);
    v = warp_max(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) v = max(v, red[i]);
    amax = v;
  }
  // bit_length(max(a, 1)), the reference's popcount over 1 << b thresholds
  const int need = 32 - __clz(max(amax, 1));
  int t = max(need - (kOutBits - 1), 0);
  t = min(max(t, q_scale[0]), kAccBits - kOutBits);
  if (blockIdx.y == 0 && threadIdx.x == 0) t_out[m] = t;

  const int n = blockIdx.y * kThreads + threadIdx.x;
  if (n >= N) return;
  const size_t o = (size_t)m * N + n;
  int u = (trunc8(acc[o], t) & 0xFF) ^ oflips[o];
  if (acc_d != nullptr && imp[n] != 0)
    u = (trunc8(acc_d[o], t) & 0xFF) ^ dflips[o];
  y[o] = (int8_t)sext8(u);
}

}  // namespace

extern "C" {

// dppu: 0 none, 1 reuse (recompute == acc), 2 separate accumulator from w2.
// wflips != nullptr selects the per-row weight-flip GEMM.  Returns the CUDA
// error of the launches (0 on success); the caller raises on anything else.
int fused_decode_launch(const void* x, const void* w, const void* w2,
                        const void* wflips, const void* oflips,
                        const void* dflips, const void* imp,
                        const void* q_scale, void* acc, void* acc_d,
                        void* rowmax, void* y, void* t, int M, int N, int K,
                        int per_row, int dppu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  cudaError_t err = cudaMemsetAsync(rowmax, 0, sizeof(int32_t) * M, s);
  if (err != cudaSuccess) return err;
  const bool dual = dppu == 2;
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto w2p = static_cast<const int8_t*>(w2);
  auto ap = static_cast<int32_t*>(acc);
  auto a2p = static_cast<int32_t*>(acc_d);
  auto rp = static_cast<int32_t*>(rowmax);
  if (wflips != nullptr) {
    dim3 grid(M, (N + kThreads - 1) / kThreads);
    auto wf = static_cast<const int32_t*>(wflips);
    if (dual)
      fused_decode_gemm_perrow<true><<<grid, kThreads, 0, s>>>(xp, wp, w2p, wf, ap, a2p, rp, M, N, K);
    else
      fused_decode_gemm_perrow<false><<<grid, kThreads, 0, s>>>(xp, wp, w2p, wf, ap, a2p, rp, M, N, K);
  } else if (M <= 16) {
    dim3 grid((N + 63) / 64, (M + 15) / 16);
    if (dual)
      fused_decode_gemm_shared<1, true><<<grid, kThreads, 0, s>>>(xp, wp, w2p, ap, a2p, rp, M, N, K);
    else
      fused_decode_gemm_shared<1, false><<<grid, kThreads, 0, s>>>(xp, wp, w2p, ap, a2p, rp, M, N, K);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    if (dual)
      fused_decode_gemm_shared<4, true><<<grid, kThreads, 0, s>>>(xp, wp, w2p, ap, a2p, rp, M, N, K);
    else
      fused_decode_gemm_shared<4, false><<<grid, kThreads, 0, s>>>(xp, wp, w2p, ap, a2p, rp, M, N, K);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int32_t* accd = dppu == 0 ? nullptr : (dppu == 1 ? ap : a2p);
  fused_decode_epilogue<<<dim3(M, (N + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      ap, accd, rp, static_cast<const int32_t*>(oflips),
      static_cast<const int32_t*>(dflips), static_cast<const int32_t*>(imp),
      static_cast<const int32_t*>(q_scale), static_cast<int8_t*>(y),
      static_cast<int32_t*>(t), M, N, per_row);
  return cudaGetLastError();
}

const char* fused_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
