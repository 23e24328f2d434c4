// Causal flash attention over a whole prompt (one-shot prefill).
//
// Replaces src/repro/kernels/flash_prefill.py::flash_prefill_pallas
// (pallas_call at flash_prefill.py:173).
//
//   q        (B, Sq, H, D) f32, unscaled: the kernel scales it by `scale`
//            (the caller's D^-1/2), as the TPU kernel does
//   k/v      (B, Sk, KVH, D) f32; query head h reads kv-head h / (H / KVH)
//            (GQA heads are indexed, never repeated in memory)
//   q_offset, q_lens, k_lens  (B,) int32 device data, or null for
//            (0, Sq, Sk): query i of row b sits at position q_offset[b] + i
//            and attends keys < k_lens[b] (and <= its position when causal)
//   out      (B, Sq, H, D) f32; queries at or past q_lens[b], and queries
//            with no live key, are exactly 0
//
// What bounds it on an H100: operations.  Every K/V tile is used by the 64
// query rows of a block, and the products run in f32 on the CUDA cores
// (67 TFLOP/s), not the tensor cores: the port keeps f32 attention.
//
// Design: the structure of paged_prefill_attention.cu, read straight from
// the (B, S, KVH, D) layout.  One block per (b, query head, tile of 64 query
// rows).  It walks only the key tiles some live row of the tile needs: up to
// min(k_len, q_offset + last live row + 1) when causal -- tiles past a row's
// extent or wholly above the diagonal are neither read nor computed.  Ragged
// tails of every extent are masked inside the tile, so any prompt length
// works with one tile size (no divisor search).  Each thread owns a 4 x 4
// tile of the 64 x 64 score block and a 4 x (D/16) tile of the output; Q, K
// and P are stored transposed with one word of padding so the inner loops
// read distinct banks.  The online softmax gives masked keys probability
// exactly 0 and rescales the output once per tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 64;        // query rows per block
constexpr int kTK = 64;       // keys per tile
constexpr int kLd = 65;       // padded stride of the transposed tiles
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_offset,
    const int* __restrict__ q_lens, const int* __restrict__ k_lens,
    float* __restrict__ out, int Sq, int Sk, int H, int KVH, int causal,
    float scale) {
  extern __shared__ float sm[];
  float* QsT = sm;                   // [D][kLd]   q rows, transposed
  float* KsT = QsT + D * kLd;        // [D][kLd]   k tile, transposed
  float* Vs = KsT + D * kLd;         // [kTK][D]
  float* PsT = Vs + kTK * D;         // [kTK][kLd] probabilities, transposed

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int kvh = h / (H / KVH);
  const int r0 = blockIdx.y * kR;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int off = q_offset ? q_offset[b] : 0;
  const int qlen = min(q_lens ? q_lens[b] : Sq, Sq);
  const int klen = max(min(k_lens ? k_lens[b] : Sk, Sk), 0);
  const int nrows = min(qlen - r0, kR);    // live query rows of this block
  int kend = klen;                         // keys any live row needs
  if (causal) kend = min(kend, off + r0 + nrows);
  constexpr int DJ = D / 16;

  float mrow[4], lrow[4], o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = kNegInf;
    lrow[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  }

  if (nrows > 0 && kend > 0) {
    for (int i = tid; i < kR * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      QsT[d * kLd + r] =
          r < nrows ? q[(((size_t)b * Sq + r0 + r) * H + h) * D + d] * scale
                    : 0.f;
    }
    for (int t0 = 0; t0 < kend; t0 += kTK) {
      __syncthreads();
      for (int i = tid; i < kTK * D; i += kThreads) {
        const int t = i / D, d = i - t * D;
        float kv = 0.f, vv = 0.f;
        if (t0 + t < kend) {
          const size_t at = (((size_t)b * Sk + t0 + t) * KVH + kvh) * D + d;
          kv = k[at];
          vv = v[at];
        }
        KsT[d * kLd + t] = kv;
        Vs[t * D + d] = vv;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float a[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = QsT[d * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) kk[j] = KsT[d * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += a[i] * kk[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qpos = off + r0 + r;
        bool live[4];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = t0 + tx + 16 * j;
          live[j] = r < nrows && key < klen && (!causal || key <= qpos);
          if (!live[j]) s[i][j] = kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
        // the 16 threads sharing a row are the 16 tx of one half-warp
        for (int sh = 8; sh > 0; sh >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float m_new = fmaxf(mrow[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
          PsT[(tx + 16 * j) * kLd + r] = p;
          sum += p;
        }
        for (int sh = 8; sh > 0; sh >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, sh);
        const float alpha = expf(mrow[i] - m_new);
        lrow[i] = alpha * lrow[i] + sum;
        mrow[i] = m_new;
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] *= alpha;
      }
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < kTK; ++t) {
        float p[4], vv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = PsT[t * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[j] = Vs[t * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) o[i][j] += p[i] * vv[j];
      }
    }
  }

  const int total = min(Sq - r0, kR);  // rows of this block in range
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= total) continue;
    const float l = r < nrows ? lrow[i] : 0.f;
    const float den = l > 0.f ? l : 1.f;
    float* ob = out + (((size_t)b * Sq + r0 + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[tx + 16 * j] = l > 0.f ? o[i][j] / den : 0.f;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* off,
           const void* qlens, const void* klens, void* out, int B, int Sq,
           int Sk, int H, int KVH, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = (2 * D * kLd + kTK * D + kTK * kLd) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (Sq + kR - 1) / kR);
  flash_prefill_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(off),
      static_cast<const int*>(qlens), static_cast<const int*>(klens),
      static_cast<float*>(out), Sq, Sk, H, KVH, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors contiguous; D in {32, 64, 128} and H % KVH == 0 (the wrapper
// checks); q_offset/q_lens/k_lens may each be null.  Returns a cudaError_t
// (0 = launched).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* q_offset, const void* q_lens,
                             const void* k_lens, void* out, int B, int Sq,
                             int Sk, int H, int KVH, int D, int causal,
                             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, q_offset, q_lens, k_lens, out, B, Sq, Sk, H,
                        KVH, causal, scale, st);
    case 64:
      return launch<64>(q, k, v, q_offset, q_lens, k_lens, out, B, Sq, Sk, H,
                        KVH, causal, scale, st);
    case 128:
      return launch<128>(q, k, v, q_offset, q_lens, k_lens, out, B, Sq, Sk,
                         H, KVH, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
