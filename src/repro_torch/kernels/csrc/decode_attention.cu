// One-token GQA attention against a dense per-slot KV cache (flash-decode).
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention_pallas
// (pallas_call at decode_attention.py:206).
//
//   q      (B, KVH, HQ, D) f32, already scaled by 1/sqrt(D)
//   k/v    (B, S, KVH, D) f32, or int8 with ks/vs (B, S, KVH) f32
//   lens   (B,) int32: row b attends positions < min(lens[b], S)
//   out    (B, KVH, HQ, D) f32 = softmax(q k^T over live positions) v
//
// What bounds it on an H100: bytes.  Every live K/V row is read once and
// used by HQ query heads only, so the time is the live KV stream.
//
// Design: the arithmetic of paged_decode_attention.cu, with each position's
// row addressed directly instead of through a page table.  One block per
// (b, kv-head) walks only the ceil(len/64) live tiles of 64 positions (the
// TPU kernel's length pruning: dead tiles are neither read nor computed), so
// a short sequence in a long reservation costs only its own bytes.  Each
// tile is staged in shared memory with coalesced loads (int8 rows
// dequantized there with their per-(position, kv-head) scale), scores are
// warp-parallel dot products, and an online softmax folds the tile into the
// running (max, sum, acc): masked positions get probability exactly 0, and
// len = 0 gives exactly 0.  The same tile order and arithmetic as the paged
// kernel make the two bitwise equal on the same rows.  The (b, kv-head) grid
// is small (B*KVH blocks); splitting a long row over several blocks
// (split-K flash-decoding) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 64;       // positions per tile
constexpr int kThreads = 256;
constexpr int kAcc = 4;       // accumulators per thread: HQ*D <= 1024
constexpr float kNegInf = -1e30f;

template <bool INT8>
__global__ void decode_kernel(const float* __restrict__ q,
                              const void* __restrict__ kc,
                              const void* __restrict__ vc,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const int* __restrict__ lens,
                              float* __restrict__ out, int S, int KVH, int HQ,
                              int D) {
  extern __shared__ float sm[];
  float* Ks = sm;                    // [kTK][D]
  float* Vs = Ks + kTK * D;          // [kTK][D]
  float* Qs = Vs + kTK * D;          // [HQ][D]
  float* Ps = Qs + HQ * D;           // [HQ][kTK]
  float* st_m = Ps + HQ * kTK;       // [HQ]
  float* st_l = st_m + HQ;           // [HQ]
  float* st_a = st_l + HQ;           // [HQ]

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int len = max(min(lens[b], S), 0);
  const float* qb = q + ((size_t)b * KVH + h) * HQ * D;
  // cache row of position t of this (b, kv-head)
  const size_t row0 = (size_t)b * S * KVH + h;

  for (int i = tid; i < HQ * D; i += kThreads) Qs[i] = qb[i];
  for (int i = tid; i < HQ; i += kThreads) {
    st_m[i] = kNegInf;
    st_l[i] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  for (int t0 = 0; t0 < len; t0 += kTK) {
    __syncthreads();
    const int vpr = D / 4;  // 4-element words per row
    for (int i = tid; i < kTK * vpr; i += kThreads) {
      const int t = i / vpr, c = i - t * vpr;
      const int pos = t0 + t;
      float* kd = Ks + t * D + 4 * c;
      float* vd = Vs + t * D + 4 * c;
      if (pos >= len) {
        kd[0] = kd[1] = kd[2] = kd[3] = 0.f;
        vd[0] = vd[1] = vd[2] = vd[3] = 0.f;
        continue;
      }
      const size_t row = row0 + (size_t)pos * KVH;
      if (INT8) {
        const char4 kq = reinterpret_cast<const char4*>(
            static_cast<const int8_t*>(kc) + row * D)[c];
        const char4 vq = reinterpret_cast<const char4*>(
            static_cast<const int8_t*>(vc) + row * D)[c];
        const float sk = ks[row], sv = vs[row];
        kd[0] = (float)kq.x * sk; kd[1] = (float)kq.y * sk;
        kd[2] = (float)kq.z * sk; kd[3] = (float)kq.w * sk;
        vd[0] = (float)vq.x * sv; vd[1] = (float)vq.y * sv;
        vd[2] = (float)vq.z * sv; vd[3] = (float)vq.w * sv;
      } else {
        reinterpret_cast<float4*>(kd)[0] = reinterpret_cast<const float4*>(
            static_cast<const float*>(kc) + row * D)[c];
        reinterpret_cast<float4*>(vd)[0] = reinterpret_cast<const float4*>(
            static_cast<const float*>(vc) + row * D)[c];
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
        if (lane == 0) Ps[hq * kTK + t] = t0 + t < len ? s : kNegInf;
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
      const float p0 = t0 + lane < len ? expf(s0 - m_new) : 0.f;
      const float p1 = t0 + lane + 32 < len ? expf(s1 - m_new) : 0.f;
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
  }
  __syncthreads();
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

template <bool INT8>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lens, void* out, int B, int S,
           int KVH, int HQ, int D, cudaStream_t stream) {
  const size_t smem = (2 * kTK * D + HQ * D + HQ * kTK + 3 * HQ) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_kernel<INT8><<<dim3(B, KVH), kThreads, smem, stream>>>(
      static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lens),
      static_cast<float*>(out), S, KVH, HQ, D);
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors contiguous, D % 4 == 0 and HQ*D <= 1024 (the wrapper checks).
// ks/vs are ignored unless int8 != 0.  Returns a cudaError_t (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* lens, void* out, int B, int S,
                                int KVH, int HQ, int D, int int8,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8)
    return launch<true>(q, k, v, ks, vs, lens, out, B, S, KVH, HQ, D, st);
  return launch<false>(q, k, v, nullptr, nullptr, lens, out, B, S, KVH, HQ,
                       D, st);
}
