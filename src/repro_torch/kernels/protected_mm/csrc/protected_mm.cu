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
// What bounds it.  Bytes at decode: the K*N bytes of w (17.7 MB at the
// widest projection, 5.5 us) read once, about 2 int8 operations per byte
// against the card's ~590; at the narrow projections a launch's fixed
// costs (the K loop's first load, two cluster barriers).  At prefill
// (M = 256) the product is about 500 operations per byte, but the planes
// add 4 bytes per unprotected bit per output (crt3: 5 of 8, 35 MB at 256 x
// 6912), so bytes and the int8 tensor-core rate are close; this mma.sync
// core is held back by the latency of its K loop instead.
//
// Design.  The TPU kernel carries the (128, 128) accumulator in VMEM across
// a sequential K grid and runs both draws in the epilogue of the last K
// step.  Here the GEMM is dla::mma_tile, the split-K tensor-core core shared
// with fused_decode and qmatmul: the plan (kernels/plan.py::gemm_plan)
// tiles the output 16 x 64 at M <= 16 and 64 x 128 above, and splits K into
// up to 8 chunks of kc (a multiple of 64) along gridDim.z, so that the main
// path's decode shapes launch 80-540 blocks on the 132 SMs; each block
// streams its chunk of x and w through a ring of 16-byte cp.async stages,
// transposes each w tile in shared memory with __byte_perm, and accumulates
// with mma.sync.m16n8k32 s8.  The splits of one output tile are one thread
// block cluster: each parks its partials in shared memory, and after a
// cluster barrier each block sums its slice of the tile over the cluster's
// shared memory (dla::park, dla::Slice).  Since t is static, the same
// launch finishes the word: one launch per call, no scratch.
//
// The epilogue works on 4 columns of a row at a time (dla::window_quads,
// shared with qmatmul, then dla::flip8x4): one 16-byte load of the parked
// sums per block of the cluster, and 16-byte plane loads, which keep
// enough bytes in flight at two blocks per SM.  Each word reads only the
// stream its channel selects, and of it only the planes of its unprotected
// bits (8 - nb or 8 - ib): the same result as computing both draws and
// selecting.  Where N, the planes or y do not allow 16-byte loads and
// 4-byte stores, it goes word by word.
//
// Exactness.  Every partial and every total is an exact int32: |acc| <=
// 128 * 128 * K < 2^31 for K < 2^17, which the wrapper checks, so the
// chunks' integer sum is the product's whatever the chunks.  The 24-bit
// saturation is applied to the total only, never to a partial: a partial
// beyond 2^23 may come back under it once the other chunks are added.

#include "dla.cuh"

namespace {

using dla::DecodeCfg;
using dla::PrefillCfg;

struct Epilogue {
  const uint32_t* __restrict__ rnd_ord;
  const uint32_t* __restrict__ rnd_imp;
  const int32_t* __restrict__ imp;
  int8_t* __restrict__ y;
  int M, N, t, ib, nb;
  uint32_t thresh;

  // y[o] from its 8-bit word u (low byte) and its channel's mask bit, word
  // by word
  __device__ __forceinline__ void store1(int u, size_t o,
                                         bool important) const {
    y[o] = (int8_t)dla::sext8(dla::flip8(u & 0xFF,
                                         (important ? rnd_imp : rnd_ord) + o,
                                         (size_t)M * N, thresh,
                                         important ? ib : nb));
  }
};

template <class C>
__global__ void __launch_bounds__(C::kThreads)
protected_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    int K, int kc, int vec_x, int vec_w, int vec_p,
                    Epilogue ep) {
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int k0 = blockIdx.z * kc, k1 = min(k0 + kc, K);
  // the tile's mask bits, read once (visible after mma_tile's barriers)
  __shared__ bool important[C::BN];
  for (int c = threadIdx.x; c < C::BN; c += C::kThreads)
    important[c] = n0 + c < ep.N && ep.imp[n0 + c] != 0;
  int acc[C::MT][C::NT][4], unused[C::MT][C::NT][4];
  dla::mma_tile<C, false>(x, w, nullptr, ep.M, ep.N, K, m0, n0, k0, k1,
                          vec_x, vec_w, acc, unused);
  const auto sl = dla::park<C, false>(acc, unused, ep.M, m0);
  // 16-byte plane loads and one 4-byte store of y per quad where N, the
  // planes and y allow them, else word by word
  dla::window_quads(sl, ep.t, [=](int r, int c, int (&u)[4]) {
    const int n = n0 + c;
    const size_t o = (size_t)(m0 + r) * ep.N + n;
    if (vec_p && n + 3 < ep.N) {
      int prot[4];
      bool imp4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        imp4[e] = important[c + e];
        prot[e] = imp4[e] ? ep.ib : ep.nb;
      }
      dla::flip8x4<true>(u, prot, imp4, ep.rnd_ord, ep.rnd_imp, o,
                         (size_t)ep.M * ep.N, ep.thresh);
      *reinterpret_cast<uint32_t*>(ep.y + o) = dla::pack4(u);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < ep.N) ep.store1(u[e], o + e, important[c + e]);
    }
  });
  sl.done();
}

}  // namespace

extern "C" {

// (bm, bn, kc, splits) is the launch plan of kernels/plan.py::gemm_plan.
// Returns the CUDA error of the launch (0 on success); the caller raises on
// anything else.
int protected_mm_launch(const void* x, const void* w, const void* rnd_ord,
                        const void* rnd_imp, const void* imp, void* y, int M,
                        int N, int K, int t, unsigned int thresh, int ib,
                        int nb, int bm, int bn, int kc, int splits,
                        void* stream) {
  if (M == 0 || N == 0) return 0;
  if (!dla::plan_ok(M, N, K, bm, bn, kc, splits)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue ep{static_cast<const uint32_t*>(rnd_ord),
                    static_cast<const uint32_t*>(rnd_imp),
                    static_cast<const int32_t*>(imp), static_cast<int8_t*>(y),
                    M, N, t, ib, nb, thresh};
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  const int vx = dla::vec_ok(x, K), vw = dla::vec_ok(w, N);
  // 16-byte plane loads and 4-byte stores of y: rows of 4k words, aligned
  const int vp = N % 4 == 0 && dla::vec_ok(rnd_ord, 16) &&
                 dla::vec_ok(rnd_imp, 16) && reinterpret_cast<uintptr_t>(y) % 4 == 0;
  if (bm == DecodeCfg::BM)
    return dla::launch_mma<DecodeCfg, false>(protected_mm_kernel<DecodeCfg>, M, N, splits, s, xp, wp, K, kc, vx, vw, vp, ep);
  return dla::launch_mma<PrefillCfg, false>(protected_mm_kernel<PrefillCfg>, M, N, splits, s, xp, wp, K, kc, vx, vw, vp, ep);
}

const char* protected_mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
