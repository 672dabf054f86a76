// Bit-flip fault injection with per-channel protection, for Hopper (sm_90a),
// plain C interface.
//
// Replaces src/repro/kernels/fault_inject/kernel.py::fault_inject
// (pallas_call at :50), the Pallas TPU kernel behind
// kernels/fault_inject/ops.py::inject.  It computes, bit for bit, for each
// int32 word x[m, n] holding an 8-bit value:
//
//   bit b of (x & 0xFF) flips where plane b's uint32 word at (m, n) is below
//   thresh = min(int(ber * 2^32), 2^32 - 1), except the top protect[n] bits;
//   the result is sign-extended from 8 bits to int32.
//
// The planes arrive as the 32-bit patterns of uint32 words and are compared
// unsigned.
//
// Design.  The TPU kernel tiles (M, N) into (256, 128) blocks.  Here one
// thread owns one word: it reads the word, its channel's protection count
// and the planes of its unprotected bits (dla::flip8), and writes the
// result.  Consecutive threads take consecutive words of a row, so every
// plane is read in coalesced runs.
//
// What bounds it.  Bytes: per word 4 in, 4 out, and 4 per unprotected plane,
// a few integer operations each.  The kernel has no data reuse to exploit;
// it is within a small factor of the bandwidth bound by construction.

#include "dla.cuh"

namespace {

__global__ void __launch_bounds__(dla::kThreads)
fault_inject_kernel(const int32_t* __restrict__ x,
                    const uint32_t* __restrict__ rnd,
                    const int32_t* __restrict__ protect,
                    int32_t* __restrict__ y, size_t total, int N,
                    uint32_t thresh) {
  const size_t o = (size_t)blockIdx.x * dla::kThreads + threadIdx.x;
  if (o >= total) return;
  const int u = x[o] & 0xFF;
  y[o] = dla::sext8(dla::flip8(u, rnd + o, total, thresh,
                               protect[o % (size_t)N]));
}

}  // namespace

extern "C" {

// Returns the CUDA error of the launch (0 on success); the caller raises on
// anything else.
int fault_inject_launch(const void* x, const void* rnd, const void* protect,
                        void* y, int M, int N, unsigned int thresh,
                        void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)M * N;
  const unsigned int blocks =
      (unsigned int)((total + dla::kThreads - 1) / dla::kThreads);
  fault_inject_kernel<<<blocks, dla::kThreads, 0, s>>>(
      static_cast<const int32_t*>(x), static_cast<const uint32_t*>(rnd),
      static_cast<const int32_t*>(protect), static_cast<int32_t*>(y), total, N,
      thresh);
  return cudaGetLastError();
}

const char* fault_inject_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
