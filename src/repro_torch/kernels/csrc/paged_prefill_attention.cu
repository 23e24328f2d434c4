// Prefix segment of chunked-prefill attention, read through a page table,
// on the tensor cores in error-compensated TF32 (3xTF32).
//
// Replaces src/repro/kernels/paged_prefill_attention.py::
// paged_prefill_attention_pallas (pallas_call at paged_prefill_attention.py:215).
//
//   q          (B, C, KVH, HQ, D) f32, already scaled by 1/sqrt(D)
//   k/v pool   (NB, BS, KVH, D) f32 or bf16, or int8 with ks/vs (NB, BS,
//              KVH) f32
//   page_table (B, MB) int32, -1 = unassigned
//   pfx_lens   (B,) int32: row b attends pool positions < pfx_lens[b]
//   q_lens     (B,) int32: chunk rows at or past q_lens[b] are skipped
//   out (B, C, KVH, HQ, D), m and l (B, C, KVH, HQ), all f32: the segment's
//   flash state (normalized output, running max in natural-log units,
//   running sum).  An empty prefix, and every skipped row, is exactly
//   (0, -1e30, 0), which the merge in layers.attention_chunk_merge weights
//   at exactly zero.
//   D in {32, 64, 128}; q, pools and scales 16-byte aligned (the wrapper
//   checks)
//
// What bounds it on an H100: operations at the chunk step's shapes, bytes
// when few query rows share the prefix.  Each prefix K/V tile is used by
// the 64 query rows of a block; the two products run on the tensor cores as
// three TF32 products each (tf32x3.cuh: the split, the warp tiling and the
// merge, shared with flash_prefill.cu).
//
// Design:
//  * Rows.  One block of 8 warps per (b, kv-head, 64 query rows), rows being
//    the (chunk position, query head) pairs of the kv-head: GQA heads share
//    every K/V tile.  Q is scaled by log2(e) (scores in base 2) and split
//    once into registers; m is returned as m2 * ln(2).  A warp pair covers
//    16 rows, one warp for each 32-key half of a tile; no causal diagonal,
//    since every prefix key lies below every chunk query.
//  * Loads through the page table.  Each 64-key tile arrives by 16-byte
//    cp.async.cg in two stages: tile t + 1's copies, and tile t + 2's
//    page-table lookups, are issued before tile t is split and computed: a
//    lookup a tile ahead keeps a thread from stalling on the table before
//    its copies.  Each key row looks up its own page (max(pt, 0): a -1
//    entry inside the prefix reads pool block 0, as the reference does, and
//    only pfx_lens masks), so a tile may span pages of any size; keys past
//    the prefix are zero-filled by the src-size operand.  Consecutive lanes
//    copy consecutive 16 bytes of a row.
//  * int8 and bf16 pools.  The rows are copied as they are in the pool (D
//    codes, or D bf16 values, a row; an int8 row's two scales by 4-byte
//    cp.async.ca) into a staging ring of two tiles; the split widens each
//    value to f32 (an int8 code as code * scale, the plain version's one
//    rounding; a bf16 value exactly) and writes big and small parts into
//    f32 tiles.  A widened bf16 value is exact in TF32: it is only widened
//    (tf32x3.cuh's widen_tile_bf16), has no small-part tile, and each
//    product runs two MMAs instead of three, with the same bits.
//  * Order.  Blocks go heaviest first: block i takes the i-th of the
//    (b, kv-head, row tile) triples with b ranked by its live tile count
//    (ceil(prefix / 64), 0 when q_lens[b] is 0; ties by b), so the longest
//    prefixes start first.  Each block ranks the B rows itself from
//    pfx_lens and q_lens: one launch, and the host never reads the lens.
//  * No split over the prefix: the longest block walks every tile of its
//    prefix.  At D = 64 a block holds 105 KB (f32 pool) or 87 KB (int8) of
//    shared memory, at D = 128 201 KB (f32), 131 KB (bf16) or 167 KB
//    (int8): one block (8 warps) an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// 4 bytes global -> shared, asynchronously; `full` false zero-fills them
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0));
}

// One block's split of an int8 tile: code * scale in f32, then big parts
// in Kb / Vb and small parts in Kl / Vl
template <int D>
__device__ __forceinline__ void split_tile_int8(
    const int8_t* kc, const int8_t* vc, const float* ksc, const float* vsc,
    float* Kb, float* Vb, float* Kl, float* Vl) {
  constexpr int LK = D + 8, LV = D + 4, W = D / 4;  // 4-code words a row
  for (int i = threadIdx.x; i < kTK * W; i += kThreads) {
    const int r = i / W, c = (i - r * W) * 4;
    char4 cq = *reinterpret_cast<const char4*>(kc + r * D + c);
    float sc = ksc[r];
    float4 x = make_float4((float)cq.x * sc, (float)cq.y * sc,
                           (float)cq.z * sc, (float)cq.w * sc), y;
    split4(x, y);
    *reinterpret_cast<float4*>(Kb + r * LK + c) = x;
    *reinterpret_cast<float4*>(Kl + r * LK + c) = y;
    cq = *reinterpret_cast<const char4*>(vc + r * D + c);
    sc = vsc[r];
    x = make_float4((float)cq.x * sc, (float)cq.y * sc, (float)cq.z * sc,
                    (float)cq.w * sc);
    split4(x, y);
    *reinterpret_cast<float4*>(Vb + r * LV + c) = x;
    *reinterpret_cast<float4*>(Vl + r * LV + c) = y;
  }
}

// live 64-key tiles of row b (0 when it has no query row)
__device__ __forceinline__ int live_tiles(const int* pfx_lens,
                                          const int* q_lens, int b, int C,
                                          int cap) {
  if (min(q_lens[b], C) <= 0) return 0;
  return (max(min(pfx_lens[b], cap), 0) + kTK - 1) / kTK;
}

// T: the pool's element (float, __nv_bfloat16, or int8_t with scales)
template <int D, class T>
__global__ void __launch_bounds__(kThreads, 1) paged_prefill_kernel(
    const float* __restrict__ q, const void* __restrict__ kpool,
    const void* __restrict__ vpool, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ pt,
    const int* __restrict__ pfx_lens, const int* __restrict__ q_lens,
    float* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int B, int C, int KVH, int HQ, int BS,
    int MB) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  constexpr bool RAW = !std::is_same<T, float>::value;  // staged, then split
  constexpr int LK = D + 8, LV = D + 4;   // padded row strides (floats)
  constexpr int KS = D / 8;               // k-steps of S, d-tiles of O
  constexpr int PB = D * (int)sizeof(T);  // bytes of a pool row
  constexpr int CH = PB / 16;             // 16-byte chunks a row
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;  // in TF32
  constexpr int NS = RAW ? 1 : 2;         // stages of the f32 tiles
  constexpr int NL = EXACT ? 0 : 1;       // small-part tiles (bf16: none)
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;                         // [NS][kTK][LK] f32 (raw), big
  float* Vs = Ks + NS * kTK * LK;         // [NS][kTK][LV]
  float* Kl = Vs + NS * kTK * LV;         // [NL][kTK][LK] small
  float* Vl = Kl + NL * kTK * LK;         // [NL][kTK][LV] small
  // int8 and bf16: the rows [2][kTK][PB bytes] as they land; int8 also the
  // scales [2][kTK]
  unsigned char* Kc = reinterpret_cast<unsigned char*>(Vl + NL * kTK * LV);
  unsigned char* Vc = Kc + 2 * kTK * PB;
  float* Ksc = reinterpret_cast<float*>(Vc + 2 * kTK * PB);  // [2][kTK]
  float* Vsc = Ksc + 2 * kTK;
  __shared__ int s_b;

  // heaviest first: block i takes the i-th (b, kv-head, row tile) with b
  // ranked by its live tile count
  const int cap = MB * BS;
  const int RB = (C * HQ + kR - 1) / kR;  // row tiles of a sequence
  const int rank = blockIdx.x / (KVH * RB);
  for (int bb = threadIdx.x; bb < B; bb += kThreads) {
    const int w = live_tiles(pfx_lens, q_lens, bb, C, cap);
    int r = 0;
    for (int o = 0; o < B; ++o) {
      const int wo = live_tiles(pfx_lens, q_lens, o, C, cap);
      r += wo > w || (wo == w && o < bb);
    }
    if (r == rank) s_b = bb;
  }
  __syncthreads();
  const int b = s_b;
  const int j = blockIdx.x - rank * KVH * RB;
  const int h = j % KVH, r0 = (j / KVH) * kR;  // first flattened (c, hq)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % (kR / 16), kh = warp / (kR / 16);  // rows, keys
  const int g = lane >> 2, t = lane & 3;
  const int qlen = max(min(q_lens[b], C), 0);
  const int nrows = min(qlen * HQ - r0, kR);  // live rows of this block
  const int len = max(min(pfx_lens[b], cap), 0);
  // q / out row r of the block: chunk position c, head hq
  auto row_off = [&](int r) -> size_t {
    const int gr = r0 + r, c = gr / HQ, hq = gr - c * HQ;
    return ((((size_t)b * C + c) * KVH + h) * HQ + hq) * D;
  };

  // this lane's two rows (of the block); a live row attends keys < len
  const int ra = 16 * rg + g, rb = ra + 8;
  const int lim_a = ra < nrows ? len : 0, lim_b = rb < nrows ? len : 0;
  const int wend = nrows - 16 * rg > 0 ? len : 0;  // keys this warp needs

  float o[KS][4], mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  if (nrows > 0 && len > 0) {
    // Q's A fragments, scaled to base 2 and split once: a0/a1 (rows g,
    // g + 8) at column t = d 2t, a2/a3 at column t + 4 = d 2t + 1
    uint32_t qb[KS][4], qs[KS][4];
    {
      const float* qa = q + row_off(ra) + 2 * t;
      const float* qc = q + row_off(rb) + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float2 xa = make_float2(0.f, 0.f), xb = xa;
        if (ra < nrows) xa = *reinterpret_cast<const float2*>(qa + 8 * kk);
        if (rb < nrows) xb = *reinterpret_cast<const float2*>(qc + 8 * kk);
        split(xa.x * kLog2e, qb[kk][0], qs[kk][0]);
        split(xb.x * kLog2e, qb[kk][1], qs[kk][1]);
        split(xa.y * kLog2e, qb[kk][2], qs[kk][2]);
        split(xb.y * kLog2e, qb[kk][3], qs[kk][3]);
      }
    }

    const int ntiles = (len + kTK - 1) / kTK;
    const int* ptb = pt + (size_t)b * MB;
    // the page size as a shift where it is a power of two (16, 64, 128)
    const int sh = BS & (BS - 1) ? -1 : __ffs(BS) - 1;
    // each thread copies 16-byte chunk c of key row r for the kPass
    // indices i = threadIdx.x + p * kThreads: consecutive lanes, consecutive
    // chunks of a row
    constexpr int kPass = (kTK * CH + kThreads - 1) / kThreads;
    // the page of each of those rows, read a tile ahead of its copy so that
    // the table's latency hides behind a tile's compute
    int page[kPass];
    auto lookup = [&](int tile) {
#pragma unroll
      for (int p = 0; p < kPass; ++p) {
        const int i = threadIdx.x + p * kThreads;
        if (kTK * CH % kThreads && i >= kTK * CH) break;
        const int pos = tile * kTK + i / CH;
        page[p] = pos < len ? ptb[sh >= 0 ? pos >> sh : pos / BS] : 0;
      }
    };
    // tile `tile` into stage `stage`, once lookup(tile) has run
    auto load = [&](int tile, int stage) {
#pragma unroll
      for (int p = 0; p < kPass; ++p) {
        const int i = threadIdx.x + p * kThreads;
        if (kTK * CH % kThreads && i >= kTK * CH) break;
        const int r = i / CH, c = i - r * CH;
        const int pos = tile * kTK + r;
        const bool in = pos < len;
        size_t row = 0;  // pool row (block, offset, kv-head)
        if (in)  // a -1 entry reads pool block 0: only len masks
          row = ((size_t)max(page[p], 0) * BS
                 + (sh >= 0 ? pos & (BS - 1) : pos % BS)) * KVH + h;
        if (RAW) {
          const int at = (stage * kTK + r) * PB + 16 * c;
          cp_async16(Kc + at,
                     static_cast<const unsigned char*>(kpool) + row * PB +
                         16 * c,
                     in);
          cp_async16(Vc + at,
                     static_cast<const unsigned char*>(vpool) + row * PB +
                         16 * c,
                     in);
          if (INT8 && c == 0) {
            cp_async4(Ksc + stage * kTK + r, ks + row, in);
            cp_async4(Vsc + stage * kTK + r, vs + row, in);
          }
        } else {
          cp_async16(Ks + (stage * kTK + r) * LK + 4 * c,
                     static_cast<const float*>(kpool) + row * D + 4 * c, in);
          cp_async16(Vs + (stage * kTK + r) * LV + 4 * c,
                     static_cast<const float*>(vpool) + row * D + 4 * c, in);
        }
      }
      asm volatile("cp.async.commit_group;");
    };

    lookup(0);
    load(0, 0);
    if (ntiles > 1) lookup(1);
    for (int it = 0; it < ntiles; ++it) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();  // tile it is in; every warp is done with it - 1
      if (it + 1 < ntiles) {
        load(it + 1, (it + 1) & 1);
        if (it + 2 < ntiles) lookup(it + 2);
      }
      const int st = RAW ? 0 : it & 1;
      float* kt = Ks + st * kTK * LK;
      float* vt = Vs + st * kTK * LV;
      const unsigned char* kc = Kc + (it & 1) * kTK * PB;
      const unsigned char* vc = Vc + (it & 1) * kTK * PB;
      if constexpr (INT8)
        split_tile_int8<D>(reinterpret_cast<const int8_t*>(kc),
                           reinterpret_cast<const int8_t*>(vc),
                           Ksc + (it & 1) * kTK, Vsc + (it & 1) * kTK, kt,
                           vt, Kl, Vl);
      else if constexpr (EXACT)  // no small parts
        widen_tile_bf16<D>(reinterpret_cast<const __nv_bfloat16*>(kc),
                           reinterpret_cast<const __nv_bfloat16*>(vc), kt,
                           vt);
      else
        split_tile<D>(kt, vt, Kl, Vl);  // big in place, small beside it
      __syncthreads();
      const int k0 = kh * (kTK / kKH);  // this warp's keys in the tile
      const int t0 = it * kTK + k0;
      if (t0 >= wend) continue;  // warp-uniform: nothing this warp needs
      warp_tile<D, EXACT>(kt, Kl, vt, Vl, k0, t0, lim_a, lim_b, qb, qs,
                          mrow, lrow, o);
    }
  }

  // merge the key parts into the kh = 0 warps, which write the rows
  if (!merge_key_parts<D>(sm, mrow, lrow, o)) return;
  const int total = min(C * HQ - r0, kR);  // rows of this block in range
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rb : ra;
    if (row >= total) continue;
    const bool ok = row < nrows && len > 0;
    const float l = ok ? lrow[r] : 0.f;
    const float den = l > 0.f ? l : 1.f;
    const size_t off = row_off(row);
    float* ob = out + off + 2 * t;
#pragma unroll
    for (int n = 0; n < KS; ++n)
      *reinterpret_cast<float2*>(ob + 8 * n) =
          ok ? make_float2(o[n][2 * r] / den, o[n][2 * r + 1] / den)
             : make_float2(0.f, 0.f);
    if (t == 0) {
      m_out[off / D] = ok ? mrow[r] * kLn2 : kNegInf;
      l_out[off / D] = l;
    }
  }
}

template <int D, class T>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* ks, const void* vs, const void* pt, const void* pfx,
           const void* qlens, void* out, void* m, void* l, int B, int C,
           int KVH, int HQ, int BS, int MB, cudaStream_t stream) {
  constexpr bool RAW = !std::is_same<T, float>::value;
  // f32 tiles: f32 two stages and small; int8 one and small; bf16 one
  const int tiles = RAW ? (std::is_same<T, __nv_bfloat16>::value ? 1 : 2)
                        : 3;
  size_t smem = tiles * kTK * ((D + 8) + (D + 4)) * sizeof(float);
  if (RAW) smem += 4 * kTK * D * sizeof(T);   // two stages of K and V rows
  if (std::is_same<T, int8_t>::value) smem += 4 * kTK * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = B * KVH * ((C * HQ + kR - 1) / kR);
  paged_prefill_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), kpool, vpool,
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pt), static_cast<const int*>(pfx),
      static_cast<const int*>(qlens), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(l), B, C, KVH, HQ, BS,
      MB);
  return (int)cudaGetLastError();
}

// kind: the pool's element, 0 f32, 1 int8 (with ks/vs), 2 bf16
template <int D>
int launch_d(int kind, const void* q, const void* kpool, const void* vpool,
             const void* ks, const void* vs, const void* pt, const void* pfx,
             const void* qlens, void* out, void* m, void* l, int B, int C,
             int KVH, int HQ, int BS, int MB, cudaStream_t stream) {
  switch (kind) {
    case 0:
      return launch<D, float>(q, kpool, vpool, nullptr, nullptr, pt, pfx,
                              qlens, out, m, l, B, C, KVH, HQ, BS, MB,
                              stream);
    case 1:
      return launch<D, int8_t>(q, kpool, vpool, ks, vs, pt, pfx, qlens, out,
                               m, l, B, C, KVH, HQ, BS, MB, stream);
    case 2:
      return launch<D, __nv_bfloat16>(q, kpool, vpool, nullptr, nullptr, pt,
                                      pfx, qlens, out, m, l, B, C, KVH, HQ,
                                      BS, MB, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous; q, pools and scales 16-byte aligned; D in {32, 64,
// 128} (the wrapper checks); kind 0 f32, 1 int8 (ks/vs are ignored
// otherwise), 2 bf16.  Returns a cudaError_t (0 = launched).
extern "C" int paged_prefill_attention(
    const void* q, const void* kpool, const void* vpool, const void* ks,
    const void* vs, const void* page_table, const void* pfx_lens,
    const void* q_lens, void* out, void* m, void* l, int B, int C, int KVH,
    int HQ, int D, int BS, int MB, int kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(kind, q, kpool, vpool, ks, vs, page_table, pfx_lens,
                          q_lens, out, m, l, B, C, KVH, HQ, BS, MB, st);
    case 64:
      return launch_d<64>(kind, q, kpool, vpool, ks, vs, page_table, pfx_lens,
                          q_lens, out, m, l, B, C, KVH, HQ, BS, MB, st);
    case 128:
      return launch_d<128>(kind, q, kpool, vpool, ks, vs, page_table,
                           pfx_lens, q_lens, out, m, l, B, C, KVH, HQ, BS, MB,
                           st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
