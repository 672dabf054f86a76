// Bit-flip fault injection with per-channel protection, for Hopper (sm_90a),
// plain C interface.
//
// Replaces src/repro/kernels/fault_inject/kernel.py::fault_inject
// (pallas_call at :50), the Pallas TPU kernel behind
// kernels/fault_inject/ops.py::inject.  It computes, bit for bit, for each
// int32 word x[m, n] holding an 8-bit value:
//
//   bit b of (x & 0xFF) flips where plane b's uint32 word at (m, n) is below
//   thresh = min(int(ber * 2^32), 2^32 - 1), except the top protect[n] bits
//   (b < 8 - protect[n] in int32 arithmetic: a negative count exposes every
//   bit, 8 or more none); the result is sign-extended from 8 bits to int32.
//
// The planes arrive as the 32-bit patterns of uint32 words and are compared
// unsigned.
//
// What bounds it.  Bytes: per word 4 in, 4 out, and 4 per plane of an
// unprotected bit (crt3: 5 of 8), a few integer operations each; at the
// largest shape timed, 256 x 6912, that is 49.6 MB, 14.8 us at the card's
// 3.35 TB/s.  No data is reused, so the design moves those bytes with few
// instructions and few dependent round trips.  At 4 x N (a decode batch)
// the bytes take well under a microsecond and a launch's fixed cost sets
// the time: chip_smoke.py's floor line times the kernel at 1 x 4, and
// PERF.md holds it beside the 4 x N times.
//
// Design.  The TPU kernel tiles (M, N) into (256, 128) blocks.  Here the
// launch is 2-D: gridDim.y walks the rows and each thread of gridDim.x's
// blocks takes 4 consecutive words of a row, so there is no division per
// word.  A thread loads protect[n .. n+3] and its 4 words of x with one
// 16-byte load each, then reads plane b with one 16-byte load where some
// of its 4 words has bit b unprotected, all those loads issued together
// after the protect load (dla::flip8x4, shared with protected_mm), and
// writes its 4 words of y with one 16-byte store.  Where N is not a
// multiple of 4 or an operand is not 16-byte aligned (the launcher
// decides), a thread takes one word and reads its planes word by word
// (dla::flip8).  The loads are plain ones: in a development run,
// cache-streaming loads (ld.global.cs) of x and the planes were faster only
// where the operands outgrow L2, and slower where they fit; 2 to 8 rows
// per thread, or 256-thread blocks, were slower at every shape it timed.

#include "dla.cuh"

namespace {

constexpr int kBlock = 128;   // threads per block
constexpr int kMaxRows = 65535;   // gridDim.y's limit; rows past it loop

struct Args {
  const int32_t* __restrict__ x;
  const uint32_t* __restrict__ rnd;
  const int32_t* __restrict__ protect;
  int32_t* __restrict__ y;
  int M, N;
  uint32_t thresh;
};

// kVec: the thread takes columns n .. n+3 of its rows; else column n.
template <bool kVec>
__global__ void __launch_bounds__(kBlock) fault_inject_kernel(Args a) {
  constexpr int kPer = kVec ? 4 : 1;
  const int n = kPer * (blockIdx.x * kBlock + threadIdx.x);
  if (n >= a.N) return;
  const size_t plane = (size_t)a.M * a.N;
  if (kVec) {
    const int4 p = *reinterpret_cast<const int4*>(a.protect + n);
    const int prot[4] = {p.x, p.y, p.z, p.w};
    for (int m = blockIdx.y; m < a.M; m += gridDim.y) {
      const size_t o = (size_t)m * a.N + n;
      const int4 v = *reinterpret_cast<const int4*>(a.x + o);
      int u[4] = {v.x & 0xFF, v.y & 0xFF, v.z & 0xFF, v.w & 0xFF};
      dla::flip8x4(u, prot, a.rnd, o, plane, a.thresh);
      *reinterpret_cast<int4*>(a.y + o) =
          make_int4(dla::sext8(u[0]), dla::sext8(u[1]), dla::sext8(u[2]),
                    dla::sext8(u[3]));
    }
  } else {
    const int prot = a.protect[n];
    for (int m = blockIdx.y; m < a.M; m += gridDim.y) {
      const size_t o = (size_t)m * a.N + n;
      a.y[o] = dla::sext8(dla::flip8(a.x[o] & 0xFF, a.rnd + o, plane,
                                     a.thresh, prot));
    }
  }
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
  const Args a{static_cast<const int32_t*>(x),
               static_cast<const uint32_t*>(rnd),
               static_cast<const int32_t*>(protect), static_cast<int32_t*>(y),
               M, N, thresh};
  // 16-byte loads and stores: rows of 4k words, every base aligned (then
  // each plane's rows are too)
  const bool vec = N % 4 == 0 && dla::vec_ok(x, 16) && dla::vec_ok(rnd, 16) &&
                   dla::vec_ok(protect, 16) && dla::vec_ok(y, 16);
  const int per = vec ? 4 : 1;
  const int cols = (N + per - 1) / per;
  const dim3 grid((cols + kBlock - 1) / kBlock, M < kMaxRows ? M : kMaxRows);
  if (vec)
    fault_inject_kernel<true><<<grid, kBlock, 0, s>>>(a);
  else
    fault_inject_kernel<false><<<grid, kBlock, 0, s>>>(a);
  return cudaGetLastError();
}

const char* fault_inject_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
