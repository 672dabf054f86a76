// Quantized DLA matmul for Hopper (sm_90a), plain C interface.
//
// Replaces src/repro/kernels/qmatmul/kernel.py::qmatmul (pallas_call at :55),
// the Pallas TPU kernel behind kernels/qmatmul/ops.py::quant_linear.  It
// computes, bit for bit:
//
//   int8 x int8 products summed into an int32 accumulator, saturated to 24
//   bits, then the round-to-nearest 8-bit window [t+7 : t] at a static t,
//   saturated to int8.
//
// What bounds it.  At decode (M = 4) the work is 2*M*K*N int8 operations on
// the K*N bytes of w, about 2 operations per byte against the card's ~590
// int8 tensor-core operations per byte of HBM: the bytes of w read once
// bound it (17.7 MB at the widest projection, 5.3 us), and at the narrow
// ones (1.6 MB, 0.5 us) a launch's fixed costs do (the K loop's first load,
// two cluster barriers).  At prefill (M = 256) the product is about 500
// operations per byte, so the int8 tensor-core rate would bound it; this
// mma.sync core is held back by the latency of its K loop instead, as
// protected_mm is.
//
// Design.  The TPU kernel walks a (M/128, N/128, K/128) grid in order and
// carries the (128, 128) int32 accumulator in VMEM scratch across the K
// steps.  Here the GEMM is dla::mma_tile, the split-K tensor-core core that
// fused_decode and protected_mm run on: the plan (kernels/plan.py::
// gemm_plan) tiles the output 16 x 64 at M <= 16 and 64 x 128 above, and
// splits K into up to 8 chunks along gridDim.z, so that a decode shape
// still puts several blocks on every SM and streams w with many 16-byte
// cp.async copies in flight; the s8 mma.sync products run on the int8
// tensor cores.  The splits of one output tile are one thread block
// cluster that adds its int32 partials in distributed shared memory
// (dla::park, dla::Slice).  Since t is static, the same launch finishes
// the word, 4 columns of a row at a time (dla::window_quads, protected_mm's
// window step without the planes), with one 4-byte store of y per quad
// where N and y allow it: one launch per call, no scratch, and ragged or
// misaligned operands take masked byte loads into the same stages.
//
// Exactness.  Every partial and every total is an exact int32: |acc| <=
// 128 * 128 * K < 2^31 for K < 2^17, which the wrapper checks, so the
// chunks' integer sum is the product's whatever the chunks.  The 24-bit
// saturation is applied to the total only, never to a partial.

#include "dla.cuh"

namespace {

using dla::DecodeCfg;
using dla::PrefillCfg;

template <class C>
__global__ void __launch_bounds__(C::kThreads)
qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               int8_t* __restrict__ y, int M, int N, int K, int t, int kc,
               int vec_x, int vec_w, int vec_y) {
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int k0 = blockIdx.z * kc, k1 = min(k0 + kc, K);
  int acc[C::MT][C::NT][4], unused[C::MT][C::NT][4];
  dla::mma_tile<C, false>(x, w, nullptr, M, N, K, m0, n0, k0, k1, vec_x,
                          vec_w, acc, unused);
  const auto sl = dla::park<C, false>(acc, unused, M, m0);
  dla::window_quads(sl, t, [=](int r, int c, int (&u)[4]) {
    const int n = n0 + c;
    const size_t o = (size_t)(m0 + r) * N + n;
    if (vec_y && n + 3 < N) {
      *reinterpret_cast<uint32_t*>(y + o) = dla::pack4(u);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) y[o + e] = (int8_t)u[e];
    }
  });
  sl.done();
}

}  // namespace

extern "C" {

// (bm, bn, kc, splits) is the launch plan of kernels/plan.py::gemm_plan.
// Returns the CUDA error of the launch (0 on success); the caller raises on
// anything else.
int qmatmul_launch(const void* x, const void* w, void* y, int M, int N, int K,
                   int t, int bm, int bn, int kc, int splits, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (!dla::plan_ok(M, N, K, bm, bn, kc, splits)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto yp = static_cast<int8_t*>(y);
  const int vx = dla::vec_ok(x, K), vw = dla::vec_ok(w, N);
  // 4-byte stores of y: rows of 4k bytes, aligned
  const int vy = N % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 4 == 0;
  if (bm == DecodeCfg::BM)
    return dla::launch_mma<DecodeCfg, false>(qmatmul_kernel<DecodeCfg>, M, N, splits, s, xp, wp, yp, M, N, K, t, kc, vx, vw, vy);
  return dla::launch_mma<PrefillCfg, false>(qmatmul_kernel<PrefillCfg>, M, N, splits, s, xp, wp, yp, M, N, K, t, kc, vx, vw, vy);
}

const char* qmatmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
