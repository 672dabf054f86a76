// Fused inject -> protect -> qmatmul for Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/fused_decode/kernel.py::fused_decode (pallas_call
// at :189), the Pallas TPU kernel that every protected projection of
// prefill and decode runs through (protect_linear(backend="fused")).  It
// computes, bit for bit:
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
// What bounds it.  At decode (M = batch = 4) the work is 2*M*K*N int8
// operations on K*N weight bytes, about 2 operations per byte against the
// card's ~590 int8 operations per byte of HBM: the bytes of w (17.7 MB at
// the widest projection, 5.3 us) read once bound it, and at the narrow
// projections (1.6 MB, 0.5 us) a call's fixed costs bound it: a memset,
// two kernel launches, the K loop's first load, two cluster barriers.  At
// prefill (M = 256) the product is about 500 operations per byte, so the
// int8 tensor-core rate would bound it; this mma.sync core is held back by
// the latency of its K loop instead (about two blocks of 8 warps per SM).
//
// Design.  The TPU kernel holds the whole (M, N) accumulator in VMEM and
// walks K in order.  Here blocks run in parallel and in no order, and t
// needs the max over a row or over the whole output, so one call is a
// memset of the row maxima and two launches:
//
//   launch 1 (GEMM, dla::mma_tile): the plan (kernels/plan.py::gemm_plan)
//     tiles the output 16 x 64 at M <= 16 and 64 x 128 above, and splits K
//     into up to 8 chunks of kc (a multiple of 64) along gridDim.z, so that
//     the main path's decode shapes launch 80-540 blocks on the 132 SMs.
//     Each block streams its chunk of x and w through a 4-stage (decode)
//     or 3-stage (prefill) ring of 16-byte cp.async copies, transposes each
//     w tile in shared memory with __byte_perm (s8 mma wants B k-major),
//     and accumulates with mma.sync.m16n8k32 s8 into int32; a second B
//     operand (w2) gives the separate DPPU accumulator (dppu_src w / wcl)
//     from the same x fragments.  The splits of one output tile are one
//     thread block cluster: each parks its partials in shared memory, and
//     after a cluster barrier each block sums its slice of the tile over
//     the cluster's shared memory (dla::park, dla::Slice), stores the sums
//     unsaturated, and max-es the rows' |saturate24(acc)| in shared memory,
//     then once per row and block into the row maxima (atomicMax).
//     Per-row weight flips (off the serving path) keep their own GEMM: every
//     row has its own B operand, so a thread owns one (m, n) and builds the
//     faulty weight from the shared weight and the row's flip word as it
//     walks K.
//   launch 2 (epilogue): one block per (row, 256 columns) reduces the row
//     maxima to t (its own row, or all rows for the global t), then
//     saturates, truncates, XORs, selects and sign-extends into int8.
//
// Exactness.  Every partial and every total is an exact int32: |acc| <=
// 128 * 128 * K < 2^31 for K < 2^17, which the wrapper checks, so the
// chunks' integer sum is the product's whatever the chunks.  The 24-bit
// saturation and the maxima are taken on the total only (after the cluster
// sum, and in the epilogue), never on a partial: a partial beyond 2^23 may
// come back under it once the other chunks are added.

#include "dla.cuh"

namespace {

using dla::DecodeCfg;
using dla::PrefillCfg;

template <class C, bool kDual>
__global__ void __launch_bounds__(C::kThreads)
fused_decode_gemm(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const int8_t* __restrict__ w2, int32_t* __restrict__ acc_out,
                  int32_t* __restrict__ acc2_out,
                  int32_t* __restrict__ rowmax, int M, int N, int K, int kc,
                  int vec_x, int vec_w) {
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int k0 = blockIdx.z * kc, k1 = min(k0 + kc, K);
  int acc[C::MT][C::NT][4], acc2[C::MT][C::NT][4];
  dla::mma_tile<C, kDual>(x, w, w2, M, N, K, m0, n0, k0, k1, vec_x, vec_w,
                          acc, acc2);
  // the complete sums, stored unsaturated, and the rows' max
  // |saturate24(acc)|: per warp (a warp's 32 elements lie in one row), then
  // per block in shared memory, then one atomicMax per row and block
  const auto sl = dla::park<C, kDual>(acc, acc2, M, m0);
  int32_t* rmax = sl.rows();
  constexpr int U = 8;     // elements whose loads go before their stores
#pragma unroll
  for (int j0 = 0; j0 < sl.kPer; j0 += U) {
    int tot[U], tot2[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = sl.index(j0 + u);
      tot[u] = i < sl.end ? sl.sum(i) : 0;
      tot2[u] = kDual && i < sl.end ? sl.sum(i, true) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = sl.index(j0 + u), n = n0 + i % C::BN;
      if (i >= sl.end) continue;
      const size_t o = (size_t)(m0 + i / C::BN) * N + n;
      if (n < N) {
        acc_out[o] = tot[u];
        if (kDual) acc2_out[o] = tot2[u];
      }
      const int v = dla::warp_max(n < N ? abs(dla::saturate24(tot[u])) : 0);
      if ((threadIdx.x & 31) == 0) atomicMax(rmax + i / C::BN, v);
    }
  }
  __syncthreads();
  if (threadIdx.x < sl.end / C::BN && rmax[threadIdx.x] > 0)
    atomicMax(rowmax + m0 + threadIdx.x, rmax[threadIdx.x]);
  sl.done();
}

// Per-row weight flips: thread (m, n) walks K with its own faulty weights.
template <bool kDual>
__global__ void __launch_bounds__(dla::kThreads)
fused_decode_gemm_perrow(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const int8_t* __restrict__ w2,
                         const int32_t* __restrict__ wflips,
                         int32_t* __restrict__ acc_out,
                         int32_t* __restrict__ acc2_out,
                         int32_t* __restrict__ rowmax, int M, int N, int K) {
  const int m = blockIdx.x, n = blockIdx.y * dla::kThreads + threadIdx.x;
  int a = 0, a2 = 0;
  if (n < N) {
    const int8_t* xr = x + (size_t)m * K;
    const int32_t* wf = wflips + (size_t)m * K * N + n;
    for (int k = 0; k < K; ++k) {
      const int xv = xr[k];
      const size_t o = (size_t)k * N + n;
      a += xv * dla::sext8(((int)w[o] & 0xFF) ^ wf[(size_t)k * N]);
      if (kDual) a2 += xv * (int)w2[o];
    }
    const size_t o = (size_t)m * N + n;
    a = dla::saturate24(a);
    acc_out[o] = a;
    if (kDual) acc2_out[o] = dla::saturate24(a2);
  }
  const int rmax = dla::warp_max(n < N ? abs(a) : 0);
  if ((threadIdx.x & 31) == 0) atomicMax(rowmax + m, rmax);
}

__global__ void __launch_bounds__(dla::kThreads)
fused_decode_epilogue(const int32_t* __restrict__ acc,
                      const int32_t* __restrict__ acc_d,
                      const int32_t* __restrict__ rowmax,
                      const int32_t* __restrict__ oflips,
                      const int32_t* __restrict__ dflips,
                      const int32_t* __restrict__ imp,
                      const int32_t* __restrict__ q_scale,
                      int8_t* __restrict__ y, int32_t* __restrict__ t_out,
                      int M, int N, int per_row) {
  __shared__ int red[dla::kThreads / 32];
  const int m = blockIdx.x;
  int amax;
  if (per_row) {
    amax = rowmax[m];
  } else {
    int v = 0;
    for (int i = threadIdx.x; i < M; i += dla::kThreads) v = max(v, rowmax[i]);
    v = dla::warp_max(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = 0;
#pragma unroll
    for (int i = 0; i < dla::kThreads / 32; ++i) v = max(v, red[i]);
    amax = v;
  }
  // bit_length(max(a, 1)), the reference's popcount over 1 << b thresholds
  const int need = 32 - __clz(max(amax, 1));
  int t = max(need - (dla::kOutBits - 1), 0);
  t = min(max(t, q_scale[0]), dla::kAccBits - dla::kOutBits);
  if (blockIdx.y == 0 && threadIdx.x == 0) t_out[m] = t;

  const int n = blockIdx.y * dla::kThreads + threadIdx.x;
  if (n >= N) return;
  const size_t o = (size_t)m * N + n;
  int u = (dla::trunc8(dla::saturate24(acc[o]), t) & 0xFF) ^ oflips[o];
  if (acc_d != nullptr && imp[n] != 0)
    u = (dla::trunc8(dla::saturate24(acc_d[o]), t) & 0xFF) ^ dflips[o];
  y[o] = (int8_t)dla::sext8(u);
}

}  // namespace

extern "C" {

// dppu: 0 none, 1 reuse (recompute == acc), 2 separate accumulator from w2.
// wflips != nullptr selects the per-row weight-flip GEMM.  scratch holds
// int32 rowmax[M], acc[M * N] and, for dppu 2, acc2[M * N];
// (bm, bn, kc, splits) is the launch plan of kernels/plan.py::gemm_plan.
// Returns the CUDA error of the memset and the launches (0 on success); the
// caller raises on anything else.
int fused_decode_launch(const void* x, const void* w, const void* w2,
                        const void* wflips, const void* oflips,
                        const void* dflips, const void* imp,
                        const void* q_scale, void* scratch, void* y, void* t,
                        int M, int N, int K, int per_row, int dppu, int bm,
                        int bn, int kc, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (!dla::plan_ok(M, N, K, bm, bn, kc, splits)) return cudaErrorInvalidValue;
  const bool dual = dppu == 2;
  auto rowmax = static_cast<int32_t*>(scratch);
  int32_t* acc = rowmax + M;
  int32_t* acc2 = dual ? acc + (size_t)M * N : nullptr;
  cudaError_t err = cudaMemsetAsync(rowmax, 0, sizeof(int32_t) * M, s);
  if (err != cudaSuccess) return err;
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto w2p = static_cast<const int8_t*>(w2);
  if (wflips != nullptr) {
    dim3 grid(M, (N + dla::kThreads - 1) / dla::kThreads);
    auto wf = static_cast<const int32_t*>(wflips);
    if (dual)
      fused_decode_gemm_perrow<true><<<grid, dla::kThreads, 0, s>>>(xp, wp, w2p, wf, acc, acc2, rowmax, M, N, K);
    else
      fused_decode_gemm_perrow<false><<<grid, dla::kThreads, 0, s>>>(xp, wp, w2p, wf, acc, acc2, rowmax, M, N, K);
    err = cudaGetLastError();
  } else {
    const int vx = dla::vec_ok(x, K), vw = dla::vec_ok(w, N) && dla::vec_ok(w2, N);
    if (bm == DecodeCfg::BM)
      err = dual ? dla::launch_mma<DecodeCfg, true>(fused_decode_gemm<DecodeCfg, true>, M, N, splits, s, xp, wp, w2p, acc, acc2, rowmax, M, N, K, kc, vx, vw)
                 : dla::launch_mma<DecodeCfg, false>(fused_decode_gemm<DecodeCfg, false>, M, N, splits, s, xp, wp, w2p, acc, acc2, rowmax, M, N, K, kc, vx, vw);
    else
      err = dual ? dla::launch_mma<PrefillCfg, true>(fused_decode_gemm<PrefillCfg, true>, M, N, splits, s, xp, wp, w2p, acc, acc2, rowmax, M, N, K, kc, vx, vw)
                 : dla::launch_mma<PrefillCfg, false>(fused_decode_gemm<PrefillCfg, false>, M, N, splits, s, xp, wp, w2p, acc, acc2, rowmax, M, N, K, kc, vx, vw);
  }
  if (err != cudaSuccess) return err;
  const int32_t* accd = dppu == 0 ? nullptr : (dppu == 1 ? acc : acc2);
  fused_decode_epilogue<<<dim3(M, (N + dla::kThreads - 1) / dla::kThreads), dla::kThreads, 0, s>>>(
      acc, accd, rowmax, static_cast<const int32_t*>(oflips),
      static_cast<const int32_t*>(dflips), static_cast<const int32_t*>(imp),
      static_cast<const int32_t*>(q_scale), static_cast<int8_t*>(y),
      static_cast<int32_t*>(t), M, N, per_row);
  return cudaGetLastError();
}

const char* fused_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
