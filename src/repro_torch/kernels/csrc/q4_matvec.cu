// Q8_0 activations x packed Q4_0 weights, for every row count M.
//
// Replaces src/repro/kernels/q4_matmul.py::q4_matvec_pallas (pallas_call at
// q4_matmul.py:69).  The weights are (N, K/2) int8, two codes per byte: the
// low nibble holds the even index, the high nibble the odd one, both
// sign-extended (codes in -7..7).  Computes
//
//     out[m, n] = sum_g f32(sum_{k in g} int32(xq[m, k] * w[n, k]))
//                       * xs[m, g] * ws[n, g]
//
// What bounds it on an H100: bytes for the decode GEMV (M <= 32: each
// packed weight byte is used M times), operations at a 2048-row prefill
// (the int8 tensor-core rate).  Neither path reaches its bound: both run
// dp4a on the CUDA cores (mma/wgmma are later work).
//
// Design.  Unpacking happens in registers: a 32-bit word of 8 packed codes
// splits into its low and high nibbles with one mask each, __vsub4 sign-
// extends four nibbles at once ((u ^ 8) - 8 per byte), and __byte_perm
// interleaves them back into code order, two dp4a-ready words.
//  * M <= 32 (the TPU kernel keeps all M rows resident): the structure of
//    q8_matvec.cu.  One warp per output row n; lane l takes 16-code chunks
//    l + 32 i (8 packed bytes of weights against 16 bytes of activations),
//    the gs/16 lanes of one group sum it exactly in int32 with shuffles, and
//    the group folds into f32 as (part * xs) * ws.
//  * M > 32: a CUDA block cannot hold 2048 activation rows, so it tiles over
//    M as well as N (the structure of q8_matmul.cu): a 64 x 64 output tile
//    per block, the K loop one group at a time, the weight slice unpacked
//    into shared memory as it is staged.  Each thread's 4 x 4 int32 partials
//    never cross a group, and groups fold into f32 in order with explicitly
//    rounded products and sums (no fused multiply-add), the plain version's
//    acc + (part * xs) * ws.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatvecMaxRows = 32;
constexpr int kTile = 64;
constexpr int kThreads = 256;

// 8 packed codes -> two words of 4 sign-extended int8 codes, in code order
__device__ __forceinline__ void unpack8(unsigned int w, int& a, int& b) {
  const unsigned int lo = __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u,
                                  0x08080808u);  // codes 0, 2, 4, 6
  const unsigned int hi = __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                                  0x08080808u);  // codes 1, 3, 5, 7
  a = (int)__byte_perm(lo, hi, 0x5140);
  b = (int)__byte_perm(lo, hi, 0x7362);
}

__device__ __forceinline__ int dot16(const int4& x, const uint2& w) {
  int a0, a1, a2, a3;
  unpack8(w.x, a0, a1);
  unpack8(w.y, a2, a3);
  int s = __dp4a(x.x, a0, 0);
  s = __dp4a(x.y, a1, s);
  s = __dp4a(x.z, a2, s);
  return __dp4a(x.w, a3, s);
}

template <int MT>
__global__ void q4_matvec_kernel(const int8_t* __restrict__ xq,
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
    const uint2* wrow = reinterpret_cast<const uint2*>(wq + (size_t)n * (K / 2));
    float acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
    for (int c0 = 0; c0 < nchunks; c0 += 32) {
      const int c = c0 + lane;
      const bool live = c < nchunks;
      const uint2 w = live ? __ldg(wrow + c) : make_uint2(0u, 0u);
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

__global__ void q4_matmul_kernel(const int8_t* __restrict__ xq,
                                 const float* __restrict__ xs,
                                 const int8_t* __restrict__ wq,
                                 const float* __restrict__ ws,
                                 float* __restrict__ out, int M, int N, int K,
                                 int gs) {
  extern __shared__ int smem[];
  const int wpr = gs >> 2;      // 4-byte words of one row's group slice
  const int ldw = wpr + 1;      // padded row stride in words
  int* As = smem;               // [kTile][ldw] activation codes
  int* Bs = smem + kTile * ldw; // [kTile][ldw] unpacked weight codes
  const int G = K / gs;
  const int kh = K / 2;         // packed bytes per weight row
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
      const int m = m0 + r;
      As[r * ldw + c] =
          m < M ? __ldg(reinterpret_cast<const int*>(
                      xq + (size_t)m * K + (size_t)g * gs + 4 * c))
                : 0;
    }
    // one packed word (8 codes) -> two unpacked words
    for (int idx = threadIdx.x; idx < kTile * (wpr / 2); idx += kThreads) {
      const int r = idx / (wpr / 2), c = idx - r * (wpr / 2);
      const int n = n0 + r;
      int a = 0, b = 0;
      if (n < N)
        unpack8(__ldg(reinterpret_cast<const unsigned int*>(
                    wq + (size_t)n * kh + (size_t)g * (gs / 2) + 4 * c)),
                a, b);
      Bs[r * ldw + 2 * c] = a;
      Bs[r * ldw + 2 * c + 1] = b;
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
        facc[i][j] = __fadd_rn(
            facc[i][j], __fmul_rn(__fmul_rn((float)acc[i][j], sx), sw));
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

template <int MT>
void launch_matvec(const int8_t* xq, const float* xs, const int8_t* wq,
                   const float* ws, float* out, int M, int N, int K, int gs,
                   cudaStream_t stream) {
  const int rows_per_block = kThreads / 32;
  const int blocks = (N + rows_per_block - 1) / rows_per_block;
  q4_matvec_kernel<MT><<<blocks, kThreads, 0, stream>>>(xq, xs, wq, ws, out,
                                                        M, N, K, gs);
}

}  // namespace

// xq (M, K) int8, xs (M, K/gs) f32, wq (N, K/2) int8 packed, ws (N, K/gs)
// f32, out (M, N) f32; all contiguous, xq 16-byte and wq 8-byte aligned,
// K % 16 == 0, gs in {16, 32, ..., 512} dividing K (the wrapper checks).
extern "C" int q4_matvec(const void* xq, const void* xs, const void* wq,
                         const void* ws, void* out, int M, int N, int K,
                         int gs, void* stream) {
  const int8_t* a = static_cast<const int8_t*>(xq);
  const float* as = static_cast<const float*>(xs);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > kMatvecMaxRows) {
    const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    const size_t smem = 2 * kTile * (gs / 4 + 1) * sizeof(int);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          q4_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    q4_matmul_kernel<<<grid, kThreads, smem, st>>>(a, as, w, s, o, M, N, K,
                                                   gs);
  } else if (M <= 1) launch_matvec<1>(a, as, w, s, o, M, N, K, gs, st);
  else if (M <= 2) launch_matvec<2>(a, as, w, s, o, M, N, K, gs, st);
  else if (M <= 4) launch_matvec<4>(a, as, w, s, o, M, N, K, gs, st);
  else if (M <= 8) launch_matvec<8>(a, as, w, s, o, M, N, K, gs, st);
  else if (M <= 16) launch_matvec<16>(a, as, w, s, o, M, N, K, gs, st);
  else launch_matvec<32>(a, as, w, s, o, M, N, K, gs, st);
  return (int)cudaGetLastError();
}
