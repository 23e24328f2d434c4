// Split-K flash-decode: one-token GQA attention over a KV cache whose rows
// an address policy finds.  The mainloop and the merge of both decode
// attention kernels:
//   paged_decode_attention.cu  rows through a page table (PagedRows)
//   decode_attention.cu        rows of a dense per-slot cache (DenseRows)
// Both run the same arithmetic on the same positions in the same order, so
// on the same rows they are bitwise equal.
//
//   q      (B, KVH, HQ, D) f32, already scaled by 1/sqrt(D)
//   k/v    rows of D values, f32 or bf16 (widened to f32 as they are
//          read from shared memory), or int8 with one f32 scale a row
//   lens   (B,) int32: row b attends positions < min(lens[b], limit)
//   out    (B, KVH, HQ, D) f32 = softmax(q k^T over those positions) v;
//          a length-0 row is exactly 0
//
// What bounds it on an H100: bytes, at the least.  Every live K/V row is
// read once and used by HQ query heads only (HQ = 1 for llama2-110m, 3 for
// llama3.2-3b's 24 heads over 8 KV heads, 16 for glm4-9b's 32 over 2).  At
// llama2-110m's lengths the call is short enough that latency bounds it:
// the launch, one page-table read, one or two trips to device memory, the
// fold and the merge.  The design keeps that chain short.
//
// Design:
// - Split over positions.  The grid is (kSplit, KVH * NG, B), fixed by
//   shapes: it never depends on lens, and the host never reads them.
//   Split r of (b, kv-head, head group) takes the 64-position tiles r,
//   r + kSplit, ... of [0, len), so the work of the longest row spreads
//   over kSplit blocks.  The partition depends on len and the constants
//   only, never on the table width or the cache length.
// - Split over query heads.  A lane holds HQ*D/32 accumulators of the
//   heads it folds, at most 32 (NA): past HQ*D = 1024 the HQ heads of a KV
//   head are cut into NG groups of HQ/NG heads (the wrapper's rule,
//   ops.decode_head_groups), each its own cluster that reads the KV head's
//   rows again (mostly from L2: the NG clusters of a KV head run
//   together).  q and out are (B, KVH * NG, HQ/NG, D) in memory, so a
//   group is addressed as a KV head of its own; only the rows are shared.
//   A head's arithmetic does not depend on the heads beside it (the same
//   positions, warps and ranks), so a call is bitwise equal to NG calls on
//   the groups' slices of q, and NG = 1 is the launch of every shape up to
//   HQ*D = 1024.
// - Within a split, each warp owns positions: the 16-position chunks c =
//   warp, warp + nw, ... of the split's tiles, 4 chunks a tile.  It copies
//   them by 16-byte cp.async (8 or 4 bytes for int8 rows that are not
//   16-byte aligned) into its own slot of shared memory (bf16 and int8
//   rows as they are in the pool, int8 with their scales) and keeps its
//   own online-softmax state, so a chunk needs no block barrier.
//   Positions past len are zero-filled, never read.  One slot a warp
//   keeps 6 blocks of 4 warps on an SM at D = 64;
//   a second slot, to copy chunk j + 1 while chunk j is folded, halves
//   that and measured slower on an H100 at caches of 1024 and of 4096
//   positions: at these lengths the blocks in flight hide the latency.
// - Scores: two lanes a position, each the dot product over half of D
//   (16-byte words read in a lane-rotated order, free of bank conflicts at
//   D = 64 and 128), one shuffle to add the halves; int8 codes are summed
//   raw and scaled once.  P.V: each lane holds HQ*D/32 accumulators of its
//   block's heads (NA, a template parameter, at most 32: hence the head
//   groups); an int8 V row's scale is folded into its probability.
// - Merge inside the launch.  The warps of a block merge in warp order;
//   the kSplit blocks of a (b, kv-head, group) are one thread-block
//   cluster, and each writes its (m, l, acc) into rank 0's shared memory
//   (distributed shared memory), then arrives on the cluster barrier with
//   release.
//   Rank 0 waits with acquire and writes sum_r a_r acc_r / sum_r a_r l_r,
//   a_r = exp(m_r - max m), folding the blocks in rank order: no
//   workspace, no atomics, no second kernel, and a repeated call is bitwise
//   equal.  Only rank 0's shared memory is read remotely, and rank 0 exits
//   last, so the other blocks leave after their arrive.  An arrive at the
//   top, waited on before the first remote write, makes sure every block of
//   the cluster has started.  A split with no live tile carries (-1e30, 0,
//   0), which merges to nothing; every block reaches every barrier.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"

namespace flash_decode {

namespace cg = cooperative_groups;

constexpr int kSplit = 8;      // blocks of one (b, kv-head): one cluster
constexpr int kTile = 64;      // positions of a tile, the unit of the split
constexpr int kChunk = 16;     // positions a warp folds at a time
constexpr int kWarps = 4;      // warps of a block (fewer when D is large)
constexpr int kMinBlocks = 6;  // blocks an SM holds at D = 64
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 227 * 1024;

// Pool row (in rows of D values) of position pos of (b, kv-head h).
struct PagedRows {
  const int* pt;               // (B, MB) block ids, -1 = unassigned
  int MB, BS, KVH;
  __device__ int limit() const { return MB * BS; }
  // a -1 entry reads pool block 0, as the reference does: only len masks
  __device__ int row(int b, int h, int pos) const {
    const int bid = max(__ldg(pt + (size_t)b * MB + pos / BS), 0);
    return (bid * BS + pos % BS) * KVH + h;
  }
};

struct DenseRows {             // (B, S, KVH, D) cache
  int S, KVH;
  __device__ int limit() const { return S; }
  __device__ int row(int b, int h, int pos) const {
    return (b * S + pos) * KVH + h;
  }
};

// Dynamic shared memory, in bytes: the warps' slots, q, each warp's state
// (m, l, alpha [HQ], p [HQ][kChunk]), each warp's acc, and (written into
// rank 0 only) each block's merged (m [HQ], l [HQ], acc [HQ*D]).
struct Layout {
  size_t slot, q, warp, warp_stride, wacc, blk, total;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// elem: bytes of a K/V value (4 f32, 2 bf16, 1 int8, which adds scales)
__host__ __device__ inline Layout layout(int HQ, int D, int elem, int nw) {
  Layout L;
  const bool int8 = elem == 1;
  // K [kChunk][D], V [kChunk][D], then (int8) k and v scales [kChunk]
  L.slot = align16(2 * kChunk * D * elem + (int8 ? 2 * kChunk * 4 : 0));
  L.q = (size_t)nw * L.slot;
  L.warp = L.q + align16((size_t)HQ * D * 4);
  L.warp_stride = align16((size_t)(3 * HQ + HQ * kChunk) * 4);
  L.wacc = L.warp + nw * L.warp_stride;
  L.blk = L.wacc + align16((size_t)nw * HQ * D * 4);
  L.total = L.blk + (size_t)kSplit * (2 * HQ + HQ * D) * 4;
  return L;
}

// bytes = 16, 8 or 4; src-size 0 zero-fills dst and reads nothing
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = fill ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// the cluster barrier in halves: arrive (relaxed, or with release of this
// thread's writes) and wait (with acquire of the arrived threads' writes)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// values 4w..4w+3 of row t of a staged K or V matrix of T (int8: raw
// codes), widened to f32
template <class T>
__device__ __forceinline__ float4 word(const unsigned char* m, int t, int w,
                                       int D) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const char4 c = *reinterpret_cast<const char4*>(m + t * D + 4 * w);
    return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return widen4(reinterpret_cast<const uint2*>(m)[t * (D / 4) + w]);
  } else {
    return reinterpret_cast<const float4*>(m)[t * (D / 4) + w];
  }
}

template <class T>
__device__ __forceinline__ float value(const unsigned char* m, int t, int d,
                                       int D) {
  if constexpr (std::is_same<T, int8_t>::value)
    return (float)reinterpret_cast<const int8_t*>(m)[t * D + d];
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(m)[t * D + d]);
  else
    return reinterpret_cast<const float*>(m)[t * D + d];
}

// T: the pool's element (float, __nv_bfloat16, or int8_t with scales).
// NA: accumulators of a lane, a power of two >= HQ*D / 32 (HQ*D <= 1024).
// NG: head groups a KV head (blockIdx.y = kv-head * NG + group); HQ: query
// heads of a group.  G: bytes of one copy (16, 8 or 4).
template <class T, int NA, class Rows>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks) decode_kernel(
    const float* __restrict__ q, const unsigned char* __restrict__ kp,
    const unsigned char* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ lens,
    float* __restrict__ out, const Rows rows, int NG, int HQ, int D,
    int G) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) unsigned char sm[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // waited on before the first remote write
  const int nw = blockDim.x >> 5;
  const Layout L = layout(HQ, D, (int)sizeof(T), nw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x, h = blockIdx.y / NG, b = blockIdx.z;
  const int HD = HQ * D;
  // this group's q and out: (B, KVH * NG, HQ, D)
  const size_t qo = ((size_t)b * gridDim.y + blockIdx.y) * HD;
  const int len = max(min(__ldg(lens + b), rows.limit()), 0);
  const int rb = D * (int)sizeof(T);     // bytes of one K or V row
  const int per_row = rb / G;            // copies of one row
  // a chunk is 2 * kChunk rows (K, then V) of per_row copies: per_row
  // copies a lane; this lane's first (row, copy) and its step
  const int T0 = lane / per_row, C0 = lane % per_row;
  const int dT = 32 / per_row, dC = 32 % per_row;

  float* qs = reinterpret_cast<float*>(sm + L.q);
  float* wm = reinterpret_cast<float*>(sm + L.warp + warp * L.warp_stride);
  float* wl = wm + HQ;
  float* wa = wl + HQ;                   // alpha of the chunk just folded
  float* wp = wa + HQ;                   // [HQ][kChunk] p (int8: p * scale)
  unsigned char* slot = sm + (size_t)warp * L.slot;
  const unsigned char* km = slot;        // K [kChunk][D]
  const unsigned char* vm = slot + kChunk * rb;
  const float* ksc = reinterpret_cast<const float*>(slot + 2 * kChunk * rb);
  const float* vsc = ksc + kChunk;

  // first position of the warp's j-th chunk: chunk c = warp + j * nw of
  // the split, in tile split + kSplit * (c / 4)
  auto chunk_pos = [&](int j) {
    const int c = warp + j * nw;
    return (split + kSplit * (c >> 2)) * kTile + (c & 3) * kChunk;
  };
  // lane t < kChunk: the row of position t of chunk j (0 past the cache;
  // read before len is known, used only below it)
  auto row_of = [&](int j) {
    const int pos = chunk_pos(j) + lane;
    return lane < kChunk && pos < rows.limit() ? rows.row(b, h, pos) : 0;
  };
  // copy chunk j into the slot; lane t < kChunk holds its position t's row
  auto fetch = [&](int j, int row) {
    const int p0 = chunk_pos(j);
    if (p0 < len) {
      __syncwarp();                      // the slot's last reads are done
      int T = T0, c = C0;
      for (int i = 0; i < per_row; ++i) {
        const int t = T & (kChunk - 1);
        const bool live = p0 + t < len;
        const int rt = __shfl_sync(0xffffffffu, row, t);
        const int r = live ? rt : 0;   // past len: a legal address, unread
        const unsigned char* src = (T < kChunk ? kp : vp) + (size_t)r * rb;
        cp_async(slot + T * rb + c * G, src + c * G, G, live);
        T += dT;
        c += dC;
        if (c >= per_row) {
          c -= per_row;
          ++T;
        }
      }
      if (INT8) {                        // lane = (K or V, position)
        const int t = lane & (kChunk - 1);
        const bool live = p0 + t < len;
        const int rt = __shfl_sync(0xffffffffu, row, t);
        const int r = live ? rt : 0;
        float* dst = reinterpret_cast<float*>(slot + 2 * kChunk * rb);
        cp_async(dst + lane, (lane < kChunk ? ks : vs) + r, 4, live);
      }
      cp_commit();
    }
  };

  // the first two chunks' page-table reads go out together with lens's
  const int r0 = row_of(0);
  int next = row_of(1);
  fetch(0, r0);
  for (int i = threadIdx.x; i < HD; i += blockDim.x)
    qs[i] = q[qo + i];
  for (int i = lane; i < HQ; i += 32) {
    wm[i] = kNegInf;
    wl[i] = 0.f;
  }
  __syncthreads();

  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.f;
  const int t = lane & (kChunk - 1), half = lane / kChunk;
  // this lane's half of the 4-value words of a row
  const int nq = D / 4, h0 = (nq + 1) / 2;
  const int w0 = half ? h0 : 0, nwd = half ? nq - h0 : h0;
  const int rot = nwd ? t % nwd : 0;

  for (int j = 0; chunk_pos(j) < len; ++j) {
    cp_wait_all();
    __syncwarp();
    const bool valid = chunk_pos(j) + t < len;
    for (int hq = 0; hq < HQ; ++hq) {
      const float4* qh = reinterpret_cast<const float4*>(qs + hq * D);
      float sa = 0.f, sb = 0.f;
      int c = rot;
#pragma unroll 4
      for (int i = 0; i < nwd; ++i) {
        const float4 kv = word<T>(km, t, w0 + c, D);
        const float4 qv = qh[w0 + c];
        sa = fmaf(qv.x, kv.x, sa);
        sb = fmaf(qv.y, kv.y, sb);
        sa = fmaf(qv.z, kv.z, sa);
        sb = fmaf(qv.w, kv.w, sb);
        c = c + 1 == nwd ? 0 : c + 1;
      }
      float s = sa + sb;
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (INT8) s *= ksc[t];
      s = valid ? s : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = wm[hq];
      const float m_new = fmaxf(m_old, mx);
      const float p = valid ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        wa[hq] = alpha;
        wl[hq] = fmaf(alpha, wl[hq], sum);
        wm[hq] = m_new;
      }
      if (lane < kChunk) wp[hq * kChunk + t] = INT8 ? p * vsc[t] : p;
    }
    __syncwarp();
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int i = lane + 32 * a;
      if (i < HD) {
        const int hq = i / D, d = i - hq * D;
        const float* ph = wp + hq * kChunk;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int u = 0; u < kChunk; u += 2) {
          s0 = fmaf(ph[u], value<T>(vm, u, d, D), s0);
          s1 = fmaf(ph[u + 1], value<T>(vm, u + 1, d, D), s1);
        }
        acc[a] = fmaf(acc[a], wa[hq], s0 + s1);
      }
    }
    fetch(j + 1, next);
    next = row_of(j + 2);
  }

  // the warps' state, merged in warp order into the block's, written into
  // rank 0's shared memory
  float* wacc = reinterpret_cast<float*>(sm + L.wacc);
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int i = lane + 32 * a;
    if (i < HD) wacc[warp * HD + i] = acc[a];
  }
  __syncthreads();
  auto warp_m = [&](int w) {
    return reinterpret_cast<const float*>(sm + L.warp + w * L.warp_stride);
  };
  const int ST = 2 * HQ + HD;            // floats of one block's state
  float* gather = reinterpret_cast<float*>(sm + L.blk);
  cluster_wait();    // every block has started: rank 0's memory is live
  float* bm = cluster.map_shared_rank(gather, 0) + split * ST;
  for (int i = threadIdx.x; i < HD + HQ; i += blockDim.x) {
    const int hq = i < HD ? i / D : i - HD;
    float mx = kNegInf;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, warp_m(w)[hq]);
    float s = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float x = i < HD ? wacc[w * HD + i] : warp_m(w)[HQ + hq];
      s = fmaf(expf(warp_m(w)[hq] - mx), x, s);
    }
    if (i < HD) {
      bm[2 * HQ + i] = s;
    } else {
      bm[hq] = mx;
      bm[HQ + hq] = s;
    }
  }
  cluster_arrive();                  // release this block's state
  if (split != 0) return;
  cluster_wait();                    // acquire every block's state

  float* ob = out + qo;
  for (int i = threadIdx.x; i < HD; i += blockDim.x) {
    const int hq = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) mx = fmaxf(mx, gather[r * ST + hq]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      const float* g = gather + r * ST;
      const float a = expf(g[hq] - mx);
      num = fmaf(a, g[2 * HQ + i], num);
      den = fmaf(a, g[HQ + hq], den);
    }
    ob[i] = den > 0.f ? num / den : 0.f;
  }
}

// Launch on stream st; HQ is a group's heads.  Returns a cudaError_t (0 =
// launched).
template <class T, int NA, class Rows>
int launch(const Rows& rows, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* lens, void* out,
           int B, int KVH, int NG, int HQ, int D, cudaStream_t st) {
  constexpr int E = (int)sizeof(T);
  int nw = kWarps;
  Layout L = layout(HQ, D, E, nw);
  while (L.total > kMaxSmem && nw > 1) L = layout(HQ, D, E, nw >>= 1);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto* fn = decode_kernel<T, NA, Rows>;
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (e != cudaSuccess) return (int)e;
  }
  // the widest copy that keeps every row of both matrices aligned
  const size_t rb = (size_t)D * E;
  auto fits = [&](size_t g) {
    return rb % g == 0 && reinterpret_cast<uintptr_t>(k) % g == 0 &&
           reinterpret_cast<uintptr_t>(v) % g == 0;
  };
  const int G = fits(16) ? 16 : fits(8) ? 8 : 4;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit, KVH * NG, B);
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, fn, static_cast<const float*>(q),
      static_cast<const unsigned char*>(k),
      static_cast<const unsigned char*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lens),
      static_cast<float*>(out), rows, NG, HQ, D, G);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// HQ: query heads a KV head, in NG groups of HQ / NG
template <class T, class Rows>
int run_na(const Rows& rows, const void* q, const void* k, const void* v,
           const void* ks, const void* vs, const void* lens, void* out,
           int B, int KVH, int HQ, int NG, int D, cudaStream_t st) {
  if (NG < 1 || HQ % NG) return (int)cudaErrorInvalidValue;
  const int hq = HQ / NG, n = (hq * D + 31) / 32;
#define FD_LAUNCH(NA)                                                      \
  if (n <= NA)                                                             \
    return launch<T, NA>(rows, q, k, v, ks, vs, lens, out, B, KVH, NG, hq, \
                         D, st);
  FD_LAUNCH(1) FD_LAUNCH(2) FD_LAUNCH(4) FD_LAUNCH(8) FD_LAUNCH(16)
  FD_LAUNCH(32)
#undef FD_LAUNCH
  return (int)cudaErrorInvalidValue;    // a group's HQ*D > 1024
}

// The cache's element: kind 0 f32, 1 int8 (with ks/vs), 2 bf16.
constexpr int kF32 = 0, kInt8 = 1, kBf16 = 2;

template <class Rows>
int run(const Rows& rows, const void* q, const void* k, const void* v,
        const void* ks, const void* vs, const void* lens, void* out, int B,
        int KVH, int HQ, int NG, int D, int kind, cudaStream_t st) {
  switch (kind) {
    case kF32:
      return run_na<float>(rows, q, k, v, nullptr, nullptr, lens, out, B,
                           KVH, HQ, NG, D, st);
    case kInt8:
      return run_na<int8_t>(rows, q, k, v, ks, vs, lens, out, B, KVH, HQ,
                            NG, D, st);
    case kBf16:
      return run_na<__nv_bfloat16>(rows, q, k, v, nullptr, nullptr, lens,
                                   out, B, KVH, HQ, NG, D, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash_decode
