// Grouped Q8_0 matrix product for prefill (M > 32 activation rows).
//
// Replaces src/repro/kernels/q8_matmul.py::q8_matmul_pallas (pallas_call at
// q8_matmul.py:92).  Same function as q8_matvec:
//
//     out[m, n] = sum_g f32(sum_{k in g} int32(xq[m, k] * wq[n, k]))
//                       * xs[m, g] * ws[n, g]
//
// What bounds it on an H100: operations.  At a prefill chunk (M = 2048 rows)
// each weight byte is used 2048 times, well above the card's balance, so the
// bound is the int8 tensor-core rate.  This first version does not reach it:
// it runs the int8 products on the CUDA cores with __dp4a (a later version
// moves them to s8 mma/wgmma).
//
// Design: a 64x64 output tile per 256-thread block, each thread a 4x4
// micro-tile.  The K loop steps one quantization group at a time: the
// (64 x gs) activation and weight slices are staged in shared memory (rows
// padded by one word so the column reads hit distinct banks), every thread
// accumulates its 16 int32 dot products over the group only, and the
// epilogue of the group folds them into f32 as (part * xs) * ws -- groups
// never share an int32 accumulator, because their scales differ.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;

__global__ void q8_matmul_kernel(const int8_t* __restrict__ xq,
                                 const float* __restrict__ xs,
                                 const int8_t* __restrict__ wq,
                                 const float* __restrict__ ws,
                                 float* __restrict__ out, int M, int N, int K,
                                 int gs) {
  extern __shared__ int smem[];
  const int wpr = gs >> 2;      // 4-byte words of one row's group slice
  const int ldw = wpr + 1;      // padded row stride in words
  int* As = smem;               // [kTile][ldw]
  int* Bs = smem + kTile * ldw; // [kTile][ldw]
  const int G = K / gs;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;

  float facc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    for (int idx = threadIdx.x; idx < kTile * wpr; idx += kThreads) {
      const int r = idx / wpr, c = idx - r * wpr;
      const size_t col = (size_t)g * gs + 4 * c;
      const int m = m0 + r, n = n0 + r;
      As[r * ldw + c] =
          m < M ? __ldg(reinterpret_cast<const int*>(xq + (size_t)m * K + col))
                : 0;
      Bs[r * ldw + c] =
          n < N ? __ldg(reinterpret_cast<const int*>(wq + (size_t)n * K + col))
                : 0;
    }
    __syncthreads();
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int c = 0; c < wpr; ++c) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * ldw + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * ldw + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      const float sx = m < M ? __ldg(xs + (size_t)m * G + g) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        const float sw = n < N ? __ldg(ws + (size_t)n * G + g) : 0.f;
        facc[i][j] += ((float)acc[i][j] * sx) * sw;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = facc[i][j];
    }
  }
}

}  // namespace

// xq (M, K) int8, xs (M, K/gs) f32, wq (N, K) int8, ws (N, K/gs) f32,
// out (M, N) f32; all contiguous and 4-byte aligned, gs % 4 == 0 dividing K
// (the wrapper checks).
extern "C" int q8_matmul(const void* xq, const void* xs, const void* wq,
                         const void* ws, void* out, int M, int N, int K,
                         int gs, void* stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  const size_t smem = 2 * kTile * (gs / 4 + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        q8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  q8_matmul_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<float*>(out), M, N, K, gs);
  return (int)cudaGetLastError();
}
