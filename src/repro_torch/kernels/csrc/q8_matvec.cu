// Grouped Q8_0 GEMV for decode (M <= 32 activation rows).
//
// Replaces src/repro/kernels/q8_matvec.py::q8_matvec_pallas (pallas_call at
// q8_matvec.py:67).  Computes
//
//     out[m, n] = sum_g f32(sum_{k in g} int32(xq[m, k] * wq[n, k]))
//                       * xs[m, g] * ws[n, g]
//
// What bounds it on an H100: bytes.  Each weight byte is read once and used
// M <= 32 times, far below the card's operations-per-byte balance, so the
// time is the weight stream: N*K int8 codes plus N*K/gs f32 scales.
//
// Design: one warp per output row n streams that row in 16-byte loads (lane
// l takes chunk l + 32*i), so a warp keeps 512 contiguous bytes in flight
// per iteration and many warps per SM cover the memory latency.  A 16-byte
// chunk lies inside one group (gs % 16 == 0); four __dp4a give its int32
// partial, and a shuffle over the gs/16 lanes holding one group sums the
// group exactly in int32 -- the int32 never crosses a group boundary.  The
// group's scales are applied once in f32 as (part * xs) * ws, the plain
// version's per-group product; only the order of the f32 sum over groups
// differs.  The activations (M*K bytes) are read through the read-only path:
// every warp reuses them, so they stay in L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int dot16(const int4& a, const int4& b) {
  int s = __dp4a(a.x, b.x, 0);
  s = __dp4a(a.y, b.y, s);
  s = __dp4a(a.z, b.z, s);
  return __dp4a(a.w, b.w, s);
}

template <int MT>
__global__ void q8_matvec_kernel(const int8_t* __restrict__ xq,
                                 const float* __restrict__ xs,
                                 const int8_t* __restrict__ wq,
                                 const float* __restrict__ ws,
                                 float* __restrict__ out, int M, int N, int K,
                                 int gs) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int G = K / gs;
  const int lpg = gs >> 4;  // lanes per group: a power of two <= 32
  const int nchunks = K >> 4;
  for (int n = blockIdx.x * warps + (threadIdx.x >> 5); n < N;
       n += gridDim.x * warps) {
    const int4* wrow = reinterpret_cast<const int4*>(wq + (size_t)n * K);
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
    for (int c0 = 0; c0 < nchunks; c0 += 32) {
      const int c = c0 + lane;
      const bool live = c < nchunks;
      const int4 w = live ? __ldg(wrow + c) : make_int4(0, 0, 0, 0);
      const int g = live ? (c << 4) / gs : 0;
      const float wsc = live ? __ldg(ws + (size_t)n * G + g) : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {  // uniform across the warp: the shuffles below are safe
          int part = 0;
          if (live) {
            const int4 x =
                __ldg(reinterpret_cast<const int4*>(xq + (size_t)m * K) + c);
            part = dot16(x, w);
          }
          for (int off = 1; off < lpg; off <<= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (live && (lane & (lpg - 1)) == 0)
            acc[m] += ((float)part * __ldg(xs + (size_t)m * G + g)) * wsc;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        float v = acc[m];
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) out[(size_t)m * N + n] = v;
      }
    }
  }
}

template <int MT>
void launch(const int8_t* xq, const float* xs, const int8_t* wq,
            const float* ws, float* out, int M, int N, int K, int gs,
            cudaStream_t stream) {
  const int threads = 256;
  const int rows_per_block = threads / 32;
  const int blocks = (N + rows_per_block - 1) / rows_per_block;
  q8_matvec_kernel<MT><<<blocks, threads, 0, stream>>>(xq, xs, wq, ws, out, M,
                                                       N, K, gs);
}

}  // namespace

// xq (M, K) int8, xs (M, K/gs) f32, wq (N, K) int8, ws (N, K/gs) f32,
// out (M, N) f32; all contiguous, xq/wq 16-byte aligned, K % 16 == 0,
// gs in {16, 32, ..., 512} dividing K, 1 <= M <= 32 (the wrapper checks).
extern "C" int q8_matvec(const void* xq, const void* xs, const void* wq,
                         const void* ws, void* out, int M, int N, int K,
                         int gs, void* stream) {
  const int8_t* a = static_cast<const int8_t*>(xq);
  const float* as = static_cast<const float*>(xs);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 1) launch<1>(a, as, w, s, o, M, N, K, gs, st);
  else if (M <= 2) launch<2>(a, as, w, s, o, M, N, K, gs, st);
  else if (M <= 4) launch<4>(a, as, w, s, o, M, N, K, gs, st);
  else if (M <= 8) launch<8>(a, as, w, s, o, M, N, K, gs, st);
  else if (M <= 16) launch<16>(a, as, w, s, o, M, N, K, gs, st);
  else launch<32>(a, as, w, s, o, M, N, K, gs, st);
  return (int)cudaGetLastError();
}
