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
// Design.  The TPU kernel walks a (M/128, N/128, K/128) grid in order and
// carries the (128, 128) int32 accumulator in VMEM scratch across the K
// steps.  Here blocks run in parallel and in no order, so each block owns an
// output tile over all of K (dla::gemm_tile, shared with protected_mm) and,
// since t is static, finishes it in the same launch: one launch per call, no
// scratch in device memory, no alignment needed (ragged tiles are masked).
//
// What bounds it.  At the shapes of a danube projection (M = 4 or 256, K and
// N of 640-6912) the work is 2*M*K*N int8 operations on K*N weight bytes: at
// M = 4 about 2 operations per byte, at M = 256 about 500, both below the
// card's ~590 int8 tensor-core operations per byte of HBM traffic, so the
// bound is the bytes of w read once.  This first version does not reach it:
// dp4a on CUDA cores instead of the int8 tensor cores, and no cp.async/TMA
// pipelining of the K loop.  Its time beside the bound is in PERF.md.

#include "dla.cuh"

namespace {

template <int TM>
__global__ void __launch_bounds__(dla::kThreads)
qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               int8_t* __restrict__ y, int M, int N, int K, int t) {
  const int m0 = blockIdx.y * 16 * TM, n0 = blockIdx.x * dla::kTileN;
  int acc[TM][4];
  dla::gemm_tile<TM>(x, w, M, N, K, m0, n0, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N)
        y[(size_t)m * N + n] =
            (int8_t)dla::trunc8(dla::saturate24(acc[i][j]), t);
    }
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success); the caller raises on
// anything else.
int qmatmul_launch(const void* x, const void* w, void* y, int M, int N, int K,
                   int t, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto yp = static_cast<int8_t*>(y);
  const dim3 grid = dla::gemm_grid(M, N);
  if (dla::small_m(M))
    qmatmul_kernel<1><<<grid, dla::kThreads, 0, s>>>(xp, wp, yp, M, N, K, t);
  else
    qmatmul_kernel<4><<<grid, dla::kThreads, 0, s>>>(xp, wp, yp, M, N, K, t);
  return cudaGetLastError();
}

const char* qmatmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
