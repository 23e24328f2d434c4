// Prefix segment of chunked-prefill attention, read through a page table.
//
// Replaces src/repro/kernels/paged_prefill_attention.py::
// paged_prefill_attention_pallas (pallas_call at paged_prefill_attention.py:215).
//
//   q          (B, C, KVH, HQ, D) f32, already scaled by 1/sqrt(D)
//   k/v pool   (NB, BS, KVH, D) f32, or int8 with ks/vs (NB, BS, KVH) f32
//   page_table (B, MB) int32, -1 = unassigned
//   pfx_lens   (B,) int32: row b attends pool positions < pfx_lens[b]
//   q_lens     (B,) int32: chunk rows at or past q_lens[b] are skipped
//   out (B, C, KVH, HQ, D), m and l (B, C, KVH, HQ), all f32: the segment's
//   flash state (normalized output, running max, running sum).  An empty
//   prefix, and every skipped row, is exactly (0, -1e30, 0), which the merge
//   in layers.attention_chunk_merge weights at exactly zero.
//
// What bounds it on an H100: operations.  Each prefix K/V tile is used by
// the 64 query rows of a block, and the products run in f32 on the CUDA
// cores (67 TFLOP/s), not the tensor cores: the port keeps f32 attention.
//
// Design: one block per (b, kv-head, tile of 64 query rows, rows being the
// (chunk position, query head) pairs).  It walks only the ceil(pfx/64) live
// tiles of 64 prefix positions (each row looks up its own page, so a tile
// may span pages; a -1 entry inside the prefix reads pool block 0, as the
// reference does, and only pfx_lens masks), and dequantizes int8 rows while
// staging them in shared memory.  Each thread owns a 4x4 tile of the 64x64
// score block and a 4x(D/16) tile of the output; Q, K and P are stored
// transposed with one word of padding so the inner loops read distinct
// banks.  The online softmax rescales the output once per tile, as the TPU
// kernel's tile does; no causal diagonal is needed, since every prefix key
// lies below every chunk query.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 64;        // query rows per block
constexpr int kTK = 64;       // prefix positions per tile
constexpr int kLd = 65;       // padded stride of the transposed tiles
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D, bool INT8>
__global__ void paged_prefill_kernel(
    const float* __restrict__ q, const void* __restrict__ kpool,
    const void* __restrict__ vpool, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ pt,
    const int* __restrict__ pfx_lens, const int* __restrict__ q_lens,
    float* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int C, int KVH, int HQ, int BS, int MB) {
  extern __shared__ float sm[];
  float* QsT = sm;                   // [D][kLd]   q rows, transposed
  float* KsT = QsT + D * kLd;        // [D][kLd]   k tile, transposed
  float* Vs = KsT + D * kLd;         // [kTK][D]
  float* PsT = Vs + kTK * D;         // [kTK][kLd] probabilities, transposed
  int* rows = reinterpret_cast<int*>(PsT + kTK * kLd);  // [kTK]

  const int b = blockIdx.x / KVH, h = blockIdx.x - b * KVH;
  const int r0 = blockIdx.y * kR;    // first flattened (c, hq) row
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qlen = min(q_lens[b], C);
  const int nrows = min(qlen * HQ - r0, kR);  // live rows of this block
  const int len = min(pfx_lens[b], MB * BS);
  constexpr int DJ = D / 16;

  // q row r (local) = chunk position c, head hq; address of its D values
  auto row_off = [&](int r) -> size_t {
    const int g = r0 + r, c = g / HQ, hq = g - c * HQ;
    return ((((size_t)b * C + c) * KVH + h) * HQ + hq) * D;
  };

  float mrow[4], lrow[4], o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = kNegInf;
    lrow[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  }

  if (nrows > 0 && len > 0) {
    for (int i = tid; i < kR * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      QsT[d * kLd + r] = r < nrows ? q[row_off(r) + d] : 0.f;
    }
    for (int t0 = 0; t0 < len; t0 += kTK) {
      if (tid < kTK) {
        const int pos = t0 + tid;
        int row = -1;
        if (pos < len) {  // a -1 entry reads pool block 0: only len masks
          const int bid = max(pt[(size_t)b * MB + pos / BS], 0);
          row = (bid * BS + pos % BS) * KVH + h;
        }
        rows[tid] = row;
      }
      __syncthreads();
      for (int i = tid; i < kTK * D; i += kThreads) {
        const int t = i / D, d = i - t * D;
        const int row = rows[t];
        float kv = 0.f, vv = 0.f;
        if (row >= 0) {
          if (INT8) {
            kv = (float)static_cast<const int8_t*>(kpool)[(size_t)row * D + d]
                 * ks[row];
            vv = (float)static_cast<const int8_t*>(vpool)[(size_t)row * D + d]
                 * vs[row];
          } else {
            kv = static_cast<const float*>(kpool)[(size_t)row * D + d];
            vv = static_cast<const float*>(vpool)[(size_t)row * D + d];
          }
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
        float a[4], k[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = QsT[d * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) k[j] = KsT[d * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += a[i] * k[j];
      }
      bool live[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) live[j] = t0 + tx + 16 * j < len;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!live[j]) s[i][j] = kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
        // the 16 threads sharing a row are the 16 tx of one half-warp
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(mrow[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
          PsT[(tx + 16 * j) * kLd + ty + 16 * i] = p;
          sum += p;
        }
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float alpha = expf(mrow[i] - m_new);
        lrow[i] = alpha * lrow[i] + sum;
        mrow[i] = m_new;
#pragma unroll
        for (int j = 0; j < DJ; ++j) o[i][j] *= alpha;
      }
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < kTK; ++t) {
        float p[4], v[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = PsT[t * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) v[j] = Vs[t * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) o[i][j] += p[i] * v[j];
      }
      __syncthreads();
    }
  }

  const int total = min(C * HQ - r0, kR);  // rows of this block in range
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= total) continue;
    const bool ok = r < nrows;
    const float l = ok ? lrow[i] : 0.f;
    const float den = l > 0.f ? l : 1.f;
    const size_t off = row_off(r);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      out[off + tx + 16 * j] = ok ? o[i][j] / den : 0.f;
    if (tx == 0) {
      m_out[off / D] = ok ? mrow[i] : kNegInf;
      l_out[off / D] = l;
    }
  }
}

template <int D, bool INT8>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* ks, const void* vs, const void* pt, const void* pfx,
           const void* qlens, void* out, void* m, void* l, int B, int C,
           int KVH, int HQ, int BS, int MB, cudaStream_t stream) {
  const size_t smem =
      (2 * D * kLd + kTK * D + kTK * kLd) * sizeof(float) + kTK * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<D, INT8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * KVH, (C * HQ + kR - 1) / kR);
  paged_prefill_kernel<D, INT8><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), kpool, vpool,
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pt), static_cast<const int*>(pfx),
      static_cast<const int*>(qlens), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(l), C, KVH, HQ, BS, MB);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int int8, const void* q, const void* kpool, const void* vpool,
             const void* ks, const void* vs, const void* pt, const void* pfx,
             const void* qlens, void* out, void* m, void* l, int B, int C,
             int KVH, int HQ, int BS, int MB, cudaStream_t stream) {
  if (int8)
    return launch<D, true>(q, kpool, vpool, ks, vs, pt, pfx, qlens, out, m, l,
                           B, C, KVH, HQ, BS, MB, stream);
  return launch<D, false>(q, kpool, vpool, nullptr, nullptr, pt, pfx, qlens,
                          out, m, l, B, C, KVH, HQ, BS, MB, stream);
}

}  // namespace

// All tensors contiguous; D in {32, 64, 128} (the wrapper checks); ks/vs are
// ignored unless int8 != 0.  Returns a cudaError_t (0 = launched).
extern "C" int paged_prefill_attention(
    const void* q, const void* kpool, const void* vpool, const void* ks,
    const void* vs, const void* page_table, const void* pfx_lens,
    const void* q_lens, void* out, void* m, void* l, int B, int C, int KVH,
    int HQ, int D, int BS, int MB, int int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(int8, q, kpool, vpool, ks, vs, page_table, pfx_lens,
                          q_lens, out, m, l, B, C, KVH, HQ, BS, MB, st);
    case 64:
      return launch_d<64>(int8, q, kpool, vpool, ks, vs, page_table, pfx_lens,
                          q_lens, out, m, l, B, C, KVH, HQ, BS, MB, st);
    case 128:
      return launch_d<128>(int8, q, kpool, vpool, ks, vs, page_table,
                           pfx_lens, q_lens, out, m, l, B, C, KVH, HQ, BS, MB,
                           st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
