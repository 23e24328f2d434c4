// Flash attention on the tensor cores in error-compensated TF32 (3xTF32):
// the arithmetic both prefill attention kernels share.
//   flash_prefill.cu            causal, a whole prompt's dense K/V
//   paged_prefill_attention.cu  a chunk's queries against its sequence's
//                               prefix, K/V rows through a page table
// Each kernel owns its addressing (how Q rows and K/V tiles are found and
// copied); this header owns what happens once they are in shared memory.
//
// The split.  x = big + small with big = tf32(x), small = tf32(x - big), and
// a.b ~ big.small + small.big + big.big (small.small dropped), which keeps
// about f32's accuracy where one TF32 product keeps ~3 decimal digits.
//
// The block.  8 warps over 64 query rows: each 16-row group has two warps,
// one for each 32-key half of every 64-key tile (kKH = 2).  S = Q.K^T and
// O += P.V run as mma.sync m16n8k8 TF32 with f32 accumulators; the online
// softmax (row max, exp2f, rescale of O) runs on the accumulator fragments
// in registers, in base 2 (the kernels fold log2(e) into Q).  A row lives
// in one quad of 4 lanes, so its max is two __shfl_xor_sync steps; its sum
// stays a per-lane partial until the end, when the two warps of a row group
// merge their (m, l, O) through shared memory (merge_key_parts).
//
// Permuted k index.  Inside each k-step of 8, fragment column t stands for
// index 2t and column t + 4 for 2t + 1.  For S that makes a lane's (d 2t,
// d 2t + 1) of Q and K one float2; for P.V it makes S's accumulator (row g,
// keys 2t, 2t + 1) exactly P's A fragment, so P goes from the C layout to
// the A layout with no shuffle and no shared memory, and V's B fragment
// reads keys 2t and 2t + 1.
//
// Shared-memory tiles.  K rows at a stride of D + 8 floats (float2 reads of
// (key g, d 2t) per half-warp: banks 8g + 2t, 8g + 2t + 1), V rows at D + 4
// (reads of (key 2t or 2t + 1, dim g): banks 8t + g and 8t + 4 + g).  Each
// tile is split once, by the whole block, right after it lands: big parts in
// one buffer, small parts in another.  MMAs are issued by kind over a warp's
// independent accumulators (every big.small, then every small.big, then
// every big.big: CUTLASS's mma_tensor_op_fast_f32 order for each sum), so no
// MMA waits on the one before it.
//
// Exact operands.  A bf16 value widened to f32 fits TF32 exactly (8 bits of
// mantissa against 10), so a bf16 K or V tile has small parts exactly 0: a
// bf16 tile is only widened, holds no small-part buffer, and each product
// skips its big.small MMA (warp_tile's EXACT).  Dropping a product that
// adds exact zeros leaves every accumulator's bits as they were.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kR = 64;        // query rows per block
constexpr int kTK = 64;       // keys per tile
constexpr int kKH = 2;        // warps sharing 16 query rows, each a key part
constexpr int kJ = kTK / 8 / kKH;  // 8-key groups of a tile per warp
constexpr int kThreads = 32 * (kR / 16) * kKH;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// cvt.rna.tf32.f32 (mantissa rounded to 10 bits, ties away from zero) as
// an integer add and mask: two instructions where the PTX conversion
// compiles to several on sm_90a.  The result is exact for the tensor
// cores, which read a TF32 operand's top 19 bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a * b: one m16n8k8 TF32 product with f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 for N independent accumulators c[i] += a . b[i]: all the
// big.small products, then all the small.big, then all the big.big, so no
// two consecutive MMAs wait on one accumulator.  b[i] holds (big0, big1,
// small0, small1), TF32 bit patterns as floats.
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4],
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const float4 (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma(c[i], ab, __float_as_uint(b[i].z), __float_as_uint(b[i].w));
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma(c[i], as, __float_as_uint(b[i].x), __float_as_uint(b[i].y));
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma(c[i], ab, __float_as_uint(b[i].x), __float_as_uint(b[i].y));
}

// The same when b is exact in TF32 (small parts 0): the small.big products,
// then the big.big, as mma3 issues them after its big.small ones.  b[i]
// holds (big0, big1).
template <int N>
__device__ __forceinline__ void mma2(float (&c)[N][4],
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const float2 (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma(c[i], as, __float_as_uint(b[i].x), __float_as_uint(b[i].y));
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma(c[i], ab, __float_as_uint(b[i].x), __float_as_uint(b[i].y));
}

// x -> (big, small) in place of x and in `small`, both as floats
__device__ __forceinline__ void split_to(float& x, float& small) {
  uint32_t big, lo;
  split(x, big, lo);
  x = __uint_as_float(big);
  small = __uint_as_float(lo);
}

// four lanes of x -> big parts in x, small parts in y
__device__ __forceinline__ void split4(float4& x, float4& y) {
  split_to(x.x, y.x);
  split_to(x.y, y.y);
  split_to(x.z, y.z);
  split_to(x.w, y.w);
}

// 16 bytes global -> shared, asynchronously; `full` false zero-fills them
// (src-size 0) and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

// One block's split of an f32 K/V tile that has landed in shared memory:
// big parts in place, small parts in Kl / Vl (same strides).
template <int D>
__device__ __forceinline__ void split_tile(float* kt, float* vt, float* Kl,
                                           float* Vl) {
  constexpr int LK = D + 8, LV = D + 4, CH = D / 4;
  for (int i = threadIdx.x; i < kTK * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 4;
    float4 x = *reinterpret_cast<float4*>(kt + r * LK + c), y;
    split4(x, y);
    *reinterpret_cast<float4*>(kt + r * LK + c) = x;
    *reinterpret_cast<float4*>(Kl + r * LK + c) = y;
    x = *reinterpret_cast<float4*>(vt + r * LV + c);
    split4(x, y);
    *reinterpret_cast<float4*>(vt + r * LV + c) = x;
    *reinterpret_cast<float4*>(Vl + r * LV + c) = y;
  }
}

// A bf16 K/V tile staged as it is stored (rows of D values), widened to f32
// into Kb / Vb (same strides): exact, and exact in TF32, so it is its own
// big part and has no small part
template <int D>
__device__ __forceinline__ void widen_tile_bf16(const __nv_bfloat16* kc,
                                                const __nv_bfloat16* vc,
                                                float* Kb, float* Vb) {
  constexpr int LK = D + 8, LV = D + 4, W = D / 4;  // 4-value words a row
  for (int i = threadIdx.x; i < kTK * W; i += kThreads) {
    const int r = i / W, c = (i - r * W) * 4;
    *reinterpret_cast<float4*>(Kb + r * LK + c) =
        widen4(*reinterpret_cast<const uint2*>(kc + r * D + c));
    *reinterpret_cast<float4*>(Vb + r * LV + c) =
        widen4(*reinterpret_cast<const uint2*>(vc + r * D + c));
  }
}

// One warp's part of one split tile: S = Q.K^T over the tile's keys k0 ..
// k0 + 31 (t0 = the position of key k0), keys at or past lim_a / lim_b
// masked for the lane's rows g / g + 8 (probability exactly 0), the online
// softmax, and O += P.V.  kt / Kl and vt / Vl hold the tile's big and small
// parts; qb / qs are Q's A fragments, scaled to base 2 and split.  EXACT:
// the tile is exact in TF32 (widened bf16), Kl / Vl are not read and each
// product runs two MMAs (mma2) instead of three.
template <int D, bool EXACT = false>
__device__ __forceinline__ void warp_tile(
    const float* kt, const float* Kl, const float* vt, const float* Vl,
    int k0, int t0, int lim_a, int lim_b, const uint32_t (&qb)[D / 8][4],
    const uint32_t (&qs)[D / 8][4], float (&mrow)[2], float (&lrow)[2],
    float (&o)[D / 8][4]) {
  constexpr int LK = D + 8, LV = D + 4, KS = D / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // S = (scale q) . k^T; fragment j holds keys t0 + 8j + {2t, 2t + 1}
  float s[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (EXACT) {
      float2 kb[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        kb[j] = *reinterpret_cast<const float2*>(
            kt + (k0 + 8 * j + g) * LK + 8 * kk + 2 * t);
      mma2(s, qb[kk], qs[kk], kb);
    } else {
      float4 kb[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int at = (k0 + 8 * j + g) * LK + 8 * kk + 2 * t;
        const float2 xb = *reinterpret_cast<const float2*>(kt + at);
        const float2 xs = *reinterpret_cast<const float2*>(Kl + at);
        kb[j] = make_float4(xb.x, xb.y, xs.x, xs.y);
      }
      mma3(s, qb[kk], qs[kk], kb);
    }
  }

  // online softmax on the fragments: rows g (s[.][0..1]) and g + 8
  // (s[.][2..3]); a row's 32 keys of this warp sit in one quad
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t0 + 8 * j + 2 * t + (e & 1);
      if (key >= (e < 2 ? lim_a : lim_b)) s[j][e] = kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(mrow[r], mx[r]);
    alpha[r] = exp2f(mrow[r] - m_new);
    mrow[r] = m_new;
    lrow[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t0 + 8 * j + 2 * t + (e & 1);
      const float p = key < (e < 2 ? lim_a : lim_b)
                          ? exp2f(s[j][e] - mrow[e >> 1])
                          : 0.f;
      s[j][e] = p;
      lrow[e >> 1] += p;  // a lane's partial sum; the quad's at the end
    }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }

  // O += P . V: key group j is a k-step whose column t is key 2t and
  // column t + 4 key 2t + 1, so S's fragment is P's A fragment
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    uint32_t pb[4], ps[4];
    split(s[j][0], pb[0], ps[0]);
    split(s[j][2], pb[1], ps[1]);
    split(s[j][1], pb[2], ps[2]);
    split(s[j][3], pb[3], ps[3]);
    const int at = (k0 + 8 * j + 2 * t) * LV + g;
    if constexpr (EXACT) {
      float2 vb[KS];
#pragma unroll
      for (int n = 0; n < KS; ++n)
        vb[n] = make_float2(vt[at + 8 * n], vt[at + LV + 8 * n]);
      mma2(o, pb, ps, vb);
    } else {
      float4 vb[KS];
#pragma unroll
      for (int n = 0; n < KS; ++n)
        vb[n] = make_float4(vt[at + 8 * n], vt[at + LV + 8 * n],
                            Vl[at + 8 * n], Vl[at + LV + 8 * n]);
      mma3(o, pb, ps, vb);
    }
  }
}

// Merge the two key parts of each row group: warp kh = 1 hands its
// (m, l, O) to the warp of the same rows through shared memory `sm` (at
// least 32 * kR / 16 * (4 + D / 2) floats, free once every warp is done
// with the tiles); warp kh = 0 merges them and sums its quad's row sums
// (lanes of dead rows hold 0).  Every thread of the block must call it;
// it returns true for the warps that hold the merged rows (kh = 0).
template <int D>
__device__ __forceinline__ bool merge_key_parts(float* sm, float (&mrow)[2],
                                                float (&lrow)[2],
                                                float (&o)[D / 8][4]) {
  constexpr int KS = D / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % (kR / 16), kh = warp / (kR / 16);
  __syncthreads();  // every warp is done with the tiles
  float* xm = sm + rg * 32 + lane;  // [value][lane of the row groups]
  constexpr int kX = 32 * kR / 16;
  if (kh == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xm[r * kX] = mrow[r];
      xm[(2 + r) * kX] = lrow[r];
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xm[(4 + 4 * n + e) * kX] = o[n][e];
  }
  __syncthreads();
  if (kh == 1) return false;
  float a1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xm[r * kX], m = fmaxf(mrow[r], m1);
    const float a0 = exp2f(mrow[r] - m);
    a1[r] = exp2f(m1 - m);
    mrow[r] = m;
    lrow[r] = lrow[r] * a0 + xm[(2 + r) * kX] * a1[r];
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      o[n][2 * r] *= a0;
      o[n][2 * r + 1] *= a0;
    }
  }
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[n][e] += xm[(4 + 4 * n + e) * kX] * a1[e >> 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
  return true;
}

}  // namespace
