// The FlexHyCA PE array as one fused op, for Hopper (sm_90a), plain C
// interface.
//
// Replaces src/repro/kernels/protected_mm/kernel.py::protected_mm
// (pallas_call at :84), the Pallas TPU kernel that every projection of
// protect_linear(backend="pallas") runs through (ft/api.py::_protect_pallas;
// the serving Engine with ft_backend="pallas").  It computes, bit for bit:
//
//   1. int8 x int8 products summed into an int32 accumulator, saturated to
//      24 bits, then the round-to-nearest 8-bit window [t+7 : t] at a static
//      t (qmatmul's epilogue);
//   2. two independent fault draws on that 8-bit word: bit b flips where
//      plane b of the ordinary stream (rnd_ord) is below thresh, except the
//      top nb bits; likewise from rnd_imp, except the top ib bits;
//   3. the important-channel mask selects the second draw (the DPPU
//      recompute) over the first, then the word is sign-extended to int8.
//
// The planes are uint32 words (the threefry bits the wrapper drew), handed
// over as their 32-bit patterns and compared unsigned here.  thresh is
// min(int(ber * 2^32), 2^32 - 1), computed on the host as the reference does.
//
// Design.  The TPU kernel carries the (128, 128) accumulator in VMEM across
// a sequential K grid and runs both draws in the epilogue of the last K step.
// Here each block owns an output tile over all of K (dla::gemm_tile, shared
// with qmatmul) and runs the epilogue in the same launch, since t is static:
// one launch per call.  Each output word reads only the stream its channel
// selects, and of it only the planes of its unprotected bits (8 - nb or
// 8 - ib), so the result is the same as computing both draws and selecting.
//
// What bounds it.  The planes: 4 bytes per plane word, up to 8 planes per
// output.  At M = 256, N = 6912 the unprotected planes of crt3 (5 of 8) are
// 35 MB against 24 MB of x, w and y; at decode (M = 4) the 17.7 MB of w
// dominate.  Both are bytes, not operations (about 2-500 int8 operations
// per byte against the card's ~590).  This first version does not reach the
// bound: dp4a on CUDA cores, no pipelining of the K loop.  Its time beside
// the bound is in PERF.md.

#include "dla.cuh"

namespace {

template <int TM>
__global__ void __launch_bounds__(dla::kThreads)
protected_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const uint32_t* __restrict__ rnd_ord,
                    const uint32_t* __restrict__ rnd_imp,
                    const int32_t* __restrict__ imp, int8_t* __restrict__ y,
                    int M, int N, int K, int t, uint32_t thresh, int ib,
                    int nb) {
  const int m0 = blockIdx.y * 16 * TM, n0 = blockIdx.x * dla::kTileN;
  int acc[TM][4];
  dla::gemm_tile<TM>(x, w, M, N, K, m0, n0, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t plane = (size_t)M * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const bool important = imp[n] != 0;
    const uint32_t* rnd = important ? rnd_imp : rnd_ord;
    const int prot = important ? ib : nb;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= M) continue;
      const size_t o = (size_t)m * N + n;
      const int u = dla::trunc8(dla::saturate24(acc[i][j]), t) & 0xFF;
      y[o] = (int8_t)dla::sext8(dla::flip8(u, rnd + o, plane, thresh, prot));
    }
  }
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success); the caller raises on
// anything else.
int protected_mm_launch(const void* x, const void* w, const void* rnd_ord,
                        const void* rnd_imp, const void* imp, void* y, int M,
                        int N, int K, int t, unsigned int thresh, int ib,
                        int nb, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto ro = static_cast<const uint32_t*>(rnd_ord);
  auto ri = static_cast<const uint32_t*>(rnd_imp);
  auto ip = static_cast<const int32_t*>(imp);
  auto yp = static_cast<int8_t*>(y);
  const dim3 grid = dla::gemm_grid(M, N);
  if (dla::small_m(M))
    protected_mm_kernel<1><<<grid, dla::kThreads, 0, s>>>(
        xp, wp, ro, ri, ip, yp, M, N, K, t, thresh, ib, nb);
  else
    protected_mm_kernel<4><<<grid, dla::kThreads, 0, s>>>(
        xp, wp, ro, ri, ip, yp, M, N, K, t, thresh, ib, nb);
  return cudaGetLastError();
}

const char* protected_mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
