// One-token GQA attention read through a page table (paged flash-decode).
//
// Replaces src/repro/kernels/paged_decode_attention.py::
// paged_decode_attention_pallas (pallas_call at paged_decode_attention.py:138).
//
//   q          (B, KVH, HQ, D) f32, already scaled by 1/sqrt(D)
//   k/v pool   (NB, BS, KVH, D) f32, or int8 with ks/vs (NB, BS, KVH) f32
//   page_table (B, MB) int32, -1 = unassigned;  lens (B,) int32
//   out        (B, KVH, HQ, D) f32 = softmax(q k^T over positions < lens[b]) v
//
// What bounds it on an H100: bytes.  Every live K/V row is read once and
// used by HQ query heads only, so the time is the live KV stream.
//
// Design: one block per (b, kv-head) walks only the ceil(len/64) live tiles
// of 64 positions (a tile may span several pages or part of one; each row
// looks up its own page), so a short sequence in a long pool costs only its
// own bytes.  A -1 table entry is never dereferenced: its rows are masked.
// Each tile is staged in shared memory with coalesced loads (int8 rows are
// dequantized there with their per-(position, kv-head) scale), scores are
// warp-parallel dot products, and an online softmax folds the tile into the
// running (max, sum, acc) exactly as the TPU kernel's tile primitive does:
// masked positions get probability exactly 0, and len = 0 gives exactly 0.
// The (b, kv-head) grid is small (B*KVH blocks); splitting a long sequence
// over several blocks (split-K flash-decoding) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 64;       // positions per tile
constexpr int kThreads = 256;
constexpr int kAcc = 4;       // accumulators per thread: HQ*D <= 1024
constexpr float kNegInf = -1e30f;

template <bool INT8>
__global__ void paged_decode_kernel(const float* __restrict__ q,
                                    const void* __restrict__ kpool,
                                    const void* __restrict__ vpool,
                                    const float* __restrict__ ks,
                                    const float* __restrict__ vs,
                                    const int* __restrict__ pt,
                                    const int* __restrict__ lens,
                                    float* __restrict__ out, int KVH, int HQ,
                                    int D, int BS, int MB) {
  extern __shared__ float sm[];
  float* Ks = sm;                    // [kTK][D]
  float* Vs = Ks + kTK * D;          // [kTK][D]
  float* Qs = Vs + kTK * D;          // [HQ][D]
  float* Ps = Qs + HQ * D;           // [HQ][kTK]
  float* st_m = Ps + HQ * kTK;       // [HQ]
  float* st_l = st_m + HQ;           // [HQ]
  float* st_a = st_l + HQ;           // [HQ]
  int* rows = reinterpret_cast<int*>(st_a + HQ);  // [kTK] pool row or -1

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int len = min(lens[b], MB * BS);
  const float* qb = q + ((size_t)b * KVH + h) * HQ * D;

  for (int i = tid; i < HQ * D; i += kThreads) Qs[i] = qb[i];
  for (int i = tid; i < HQ; i += kThreads) {
    st_m[i] = kNegInf;
    st_l[i] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  for (int t0 = 0; t0 < len; t0 += kTK) {
    if (tid < kTK) {
      const int pos = t0 + tid;
      int row = -1;
      if (pos < len) {
        const int bid = pt[(size_t)b * MB + pos / BS];
        if (bid >= 0) row = (bid * BS + pos % BS) * KVH + h;
      }
      rows[tid] = row;
    }
    __syncthreads();
    if (INT8) {
      const int vpr = D / 4;  // 4-byte words per row
      for (int i = tid; i < kTK * vpr; i += kThreads) {
        const int t = i / vpr, c = i - t * vpr;
        const int row = rows[t];
        float* kd = Ks + t * D + 4 * c;
        float* vd = Vs + t * D + 4 * c;
        if (row >= 0) {
          const char4 kc = reinterpret_cast<const char4*>(
              static_cast<const int8_t*>(kpool) + (size_t)row * D)[c];
          const char4 vc = reinterpret_cast<const char4*>(
              static_cast<const int8_t*>(vpool) + (size_t)row * D)[c];
          const float sk = ks[row], sv = vs[row];
          kd[0] = (float)kc.x * sk; kd[1] = (float)kc.y * sk;
          kd[2] = (float)kc.z * sk; kd[3] = (float)kc.w * sk;
          vd[0] = (float)vc.x * sv; vd[1] = (float)vc.y * sv;
          vd[2] = (float)vc.z * sv; vd[3] = (float)vc.w * sv;
        } else {
          kd[0] = kd[1] = kd[2] = kd[3] = 0.f;
          vd[0] = vd[1] = vd[2] = vd[3] = 0.f;
        }
      }
    } else {
      const int vpr = D / 4;  // float4 per row
      for (int i = tid; i < kTK * vpr; i += kThreads) {
        const int t = i / vpr, c = i - t * vpr;
        const int row = rows[t];
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (row >= 0) {
          kv = reinterpret_cast<const float4*>(
              static_cast<const float*>(kpool) + (size_t)row * D)[c];
          vv = reinterpret_cast<const float4*>(
              static_cast<const float*>(vpool) + (size_t)row * D)[c];
        }
        reinterpret_cast<float4*>(Ks + t * D)[c] = kv;
        reinterpret_cast<float4*>(Vs + t * D)[c] = vv;
      }
    }
    __syncthreads();
    // scores: warp w takes positions w, w + 8, ...; lanes split D
    for (int t = warp; t < kTK; t += nwarps) {
      for (int hq = 0; hq < HQ; ++hq) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += Qs[hq * D + d] * Ks[t * D + d];
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) Ps[hq * kTK + t] = rows[t] >= 0 ? s : kNegInf;
      }
    }
    __syncthreads();
    // online softmax, one warp per query head
    for (int hq = warp; hq < HQ; hq += nwarps) {
      const float s0 = Ps[hq * kTK + lane], s1 = Ps[hq * kTK + lane + 32];
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = st_m[hq];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = rows[lane] >= 0 ? expf(s0 - m_new) : 0.f;
      const float p1 = rows[lane + 32] >= 0 ? expf(s1 - m_new) : 0.f;
      Ps[hq * kTK + lane] = p0;
      Ps[hq * kTK + lane + 32] = p1;
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        st_a[hq] = alpha;
        st_l[hq] = alpha * st_l[hq] + sum;
        st_m[hq] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int i = tid + a * kThreads;
      if (i < HQ * D) {
        const int hq = i / D, d = i - hq * D;
        float s = 0.f;
        for (int t = 0; t < kTK; ++t) s += Ps[hq * kTK + t] * Vs[t * D + d];
        acc[a] = acc[a] * st_a[hq] + s;
      }
    }
    __syncthreads();
  }
  float* ob = out + ((size_t)b * KVH + h) * HQ * D;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int i = tid + a * kThreads;
    if (i < HQ * D) {
      const float l = st_l[i / D];
      ob[i] = acc[a] / (l > 0.f ? l : 1.f);
    }
  }
}

}  // namespace

// All tensors contiguous, D % 4 == 0 and HQ*D <= 1024 (the wrapper checks).
// ks/vs are ignored unless int8 != 0.  Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention(const void* q, const void* kpool,
                                      const void* vpool, const void* ks,
                                      const void* vs, const void* page_table,
                                      const void* lens, void* out, int B,
                                      int KVH, int HQ, int D, int BS, int MB,
                                      int int8, void* stream) {
  const size_t smem = (2 * kTK * D + HQ * D + HQ * kTK + 3 * HQ) *
                          sizeof(float) + kTK * sizeof(int);
  const dim3 grid(B, KVH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          paged_decode_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    paged_decode_kernel<true><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), kpool, vpool,
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int*>(page_table), static_cast<const int*>(lens),
        static_cast<float*>(out), KVH, HQ, D, BS, MB);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          paged_decode_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    paged_decode_kernel<false><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), kpool, vpool, nullptr, nullptr,
        static_cast<const int*>(page_table), static_cast<const int*>(lens),
        static_cast<float*>(out), KVH, HQ, D, BS, MB);
  }
  return (int)cudaGetLastError();
}
