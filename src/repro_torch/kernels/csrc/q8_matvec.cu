// Grouped Q8_0 GEMV for decode (M <= 32 activation rows).
//
// Replaces src/repro/kernels/q8_matvec.py::q8_matvec_pallas (pallas_call at
// q8_matvec.py:67).  Computes
//
//     out[m, n] = sum_g f32(sum_{k in g} int32(xq[m, k] * wq[n, k]))
//                       * xs[m, g] * ws[n, g]
//
// Each weight byte is used M times, so the bound is bytes: ~116 MB a
// llama2-110m decode step at M = 8, 0.036 ms at 3.35 TB/s.  At these sizes
// (0.6 to 26.1 MB a call) a call is held back by latency instead: the
// launch, the device-memory round trips a warp waits for in turn, and the
// dependent instructions of the few warps a narrow layer gives each SM.
// The design is csrc/q4_matvec.cu's GEMV on int8 weights:
//  * Weights stream with few round trips.  A warp owns RW rows (2 for
//    2 < M <= 8, else 1) and takes them a slab of 1024 codes at a time: one
//    item is (RW rows, one slab) with the rows' scales, copied into a slot
//    of the warp's own ring of kStages shared-memory slots while the warp
//    computes the item before it.  A row's slab is one bulk copy
//    (cp.async.bulk, Hopper's copy engine) that completes on the slot's
//    mbarrier; the scales come by 4-byte cp.async.  Lane l then reads
//    32-code chunk l of each row.  (On an H100 80GB HBM3 at 700 W, 16-byte
//    cp.async copies by every lane, Q4's way, held the M = 1 head at ~0.021
//    ms, about as long with the arithmetic taken out; bulk copies take it
//    to ~0.014.  Two slots were as fast as four, and deeper rings slower.)
//    A 1024-code slab keeps a slot at Q4's bytes (2 KB of codes at RW =
//    2), so the head keeps Q4's occupancy.
//  * Every SM busy at every shape.  A block is 8, 4, 2 or 1 warps: the most
//    that still gives every SM a tile of rows (N = 768 at M = 8: 2 warps x 2
//    rows, 192 blocks on 132 SMs).  The grid is capped at what stays
//    resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and a block
//    walks tiles blockIdx.x + i * gridDim.x, so the head (N = 32000) keeps
//    every resident warp's ring full.
//  * Activations staged once per block.  After its first weight copies are
//    issued, the block loads xq (M x K int8: all of it up to kWholeBytes,
//    else a slab at a time) and xs, each thread one 16-byte column for all
//    M rows with up to 8 loads in flight, into shared memory; every warp
//    then reads them there, conflict-free, and one activation read serves
//    RW rows.
//  * Few instructions per code.  Int8 weight words feed dp4a as they are,
//    eight a chunk.  A 32-code chunk lies inside one group (gs >= 32) or
//    holds two whole ones (gs = 16), so a group is one lane, two
//    neighbouring lanes (gs = 64: one shuffle) or gs / 32 lanes (log2 of it
//    shuffles), and the shuffles of all M x RW sums of a chunk issue
//    together.  The f32 sum across lanes runs once per output: a butterfly
//    that halves the values a lane holds at each step.
// Numbers: each group's int32 sum is exact and folds into the lane's f32
// sum as acc + (part * xs) * ws with explicit rounding (no fused
// multiply-add), the plain version's product; only the order of the sum
// over groups differs (lane l folds chunks l, l + 32, l + 64, ... in order,
// then the butterfly over lane offsets 16, 8, 4, 2, 1: the order of the Q4
// GEMV).  Every output comes from one warp in a fixed order: no atomics,
// and the same bits from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kSlabChunks = 32;                  // 32-code chunks a slab
constexpr int kSlabCodes = 32 * kSlabChunks;     // 1024
constexpr int kStages = 2;                       // ring slots a warp
constexpr int kStageBatch = 8;                   // loads in flight a thread
constexpr int kWholeBytes = 16 * 1024;  // stage all of xq at most this big

__device__ __forceinline__ int dot16(const int4& a, const int4& b, int s) {
  s = __dp4a(a.x, b.x, s);
  s = __dp4a(a.y, b.y, s);
  s = __dp4a(a.z, b.z, s);
  return __dp4a(a.w, b.w, s);
}

// acc + (part * xs) * ws, rounded at each step as the plain version is
__device__ __forceinline__ float fold(float acc, int part, float xs,
                                      float ws) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn((float)part, xs), ws));
}

__device__ __forceinline__ unsigned int smem_u32(const void* p) {
  return (unsigned int)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) by the copy
// engine; completion counts against the mbarrier's expected bytes
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {  // one arrival
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)));
}

// the one arrival of a phase, which then also waits for `bytes`
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 16-byte units of the mbarriers, kStages a warp
constexpr int kBar16 = kMaxWarps * kStages * 8 / 16;

// Sizes of one launch, and the shared memory layout (in 16-byte units):
// the mbarriers, the staged activations, then each warp's ring of kStages
// slots.
struct Shape {
  int M, N, K, gs, lg, G;
  int cs;      // chunks of a slab: min(kSlabChunks, chunks of a row)
  int gsl;     // groups of a slab
  int nslabs;
  bool whole;  // all of K's activations staged at once, else a slab's
  int cw, gw;  // chunks and groups of the staged activations
  int act16;   // 16-byte units of the staged activations
  int slot16;  // 16-byte units of one ring slot

  __host__ __device__ Shape(int M_, int N_, int K_, int gs_, int rw)
      : M(M_), N(N_), K(K_), gs(gs_) {
    lg = 0;
    while ((1 << lg) < gs) ++lg;
    G = K >> lg;
    const int C = (K + 31) >> 5;  // the last chunk may hold 16 codes
    cs = C < kSlabChunks ? C : kSlabChunks;
    gsl = (K < kSlabCodes ? K : kSlabCodes) >> lg;
    nslabs = (K + kSlabCodes - 1) / kSlabCodes;
    whole = M * K <= kWholeBytes;
    cw = whole ? C : cs;
    gw = whole ? G : gsl;
    // x [M][2][cw] int4 (half h of chunk c), then xs [M][gw] f32
    act16 = 2 * M * cw + (M * gw + 3) / 4;
    // weights [rw][32 cs] int8 (row r's slab), then ws [rw][gsl] f32
    slot16 = 2 * rw * cs + (rw * gsl + 3) / 4;
  }
};

// Copy slab `slab` of xq and xs (all of them if s.whole) into shared
// memory: half h of row m's chunk c at sx[(2m + h) * cw + c]; a ragged
// last half is zero.  A thread takes one column of halves (or of groups)
// for every row m at once, up to kStageBatch loads in flight before it
// stores the first.
template <int MT>
__device__ __forceinline__ void stage(int4* sx, float* sxs,
                                      const int8_t* __restrict__ xq,
                                      const float* __restrict__ xs,
                                      const Shape& s, int slab) {
  const int codes0 = s.whole ? 0 : slab * kSlabCodes;
  const int len = s.whole ? s.K : min(kSlabCodes, s.K - codes0);
  const int halves = (len + 31) >> 4 & ~1;  // two per chunk, tail included
  const int groups = len >> s.lg;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float v[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      v[m] = m < s.M ? __ldg(xs + (size_t)m * s.G + (codes0 >> s.lg) + g)
                     : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < s.M) sxs[m * s.gw + g] = v[m];
  }
  for (int j = threadIdx.x; j < halves; j += blockDim.x) {
    const bool real = 16 * j < len;
    int4* dst = sx + (j & 1) * s.cw + (j >> 1);
#pragma unroll
    for (int m0 = 0; m0 < MT; m0 += kStageBatch) {
      int4 a[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch && m0 + u < MT; ++u)
        a[u] = m0 + u < s.M && real
                   ? __ldg(reinterpret_cast<const int4*>(
                               xq + (size_t)(m0 + u) * s.K + codes0) + j)
                   : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < kStageBatch && m0 + u < MT; ++u)
        if (m0 + u < s.M) dst[2 * (m0 + u) * s.cw] = a[u];
    }
  }
  __syncthreads();
}

// Start copying rows n0 .. n0 + RW - 1 of slab `slab` into a ring slot:
// each row's codes by one bulk copy on the slot's mbarrier (lane 0), the
// scales by one cp.async group.  Rows past N are not copied; their phase
// completes all the same.
template <int RW>
__device__ __forceinline__ void issue_item(int4* slot, uint64_t* bar,
                                           const int8_t* __restrict__ wq,
                                           const float* __restrict__ ws,
                                           const Shape& s, int n0, int slab,
                                           int lane) {
  const int codes0 = slab * kSlabCodes;
  const int len = min(kSlabCodes, s.K - codes0);
  const int groups = len >> s.lg;
  float* sws = reinterpret_cast<float*>(slot + 2 * RW * s.cs);
  const int nr = max(0, min(RW, s.N - n0));
  if (lane == 0) {
    // the warp's reads of the slot's last item before the copy engine's
    // writes of this one
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_expect(bar, nr * len);
    for (int r = 0; r < nr; ++r)
      bulk_copy(slot + 2 * r * s.cs, wq + (size_t)(n0 + r) * s.K + codes0,
                len, bar);
  }
  for (int r = 0; r < nr; ++r)
    for (int g = lane; g < groups; g += 32)
      cp_async4(sws + r * s.gsl + g,
                ws + (size_t)(n0 + r) * s.G + (codes0 >> s.lg) + g);
  asm volatile("cp.async.commit_group;");
}

// One warp's RW rows over one slab: lane l's chunk l folds every group it
// holds into acc[r][m].
template <int MT, int RW>
__device__ __forceinline__ void compute_item(float (&acc)[RW][MT],
                                             const int4* slot,
                                             const int4* sx,
                                             const float* sxs, const Shape& s,
                                             int slab, int lane) {
  const float* sws = reinterpret_cast<const float*>(slot + 2 * RW * s.cs);
  const int len = min(kSlabCodes, s.K - slab * kSlabCodes);
  const int c = lane;
  const bool live = 32 * c < len;
  const int g = (32 * c) >> s.lg;  // group within the slab
  const int lpg = s.gs >> 5;       // lanes a group (0 when gs = 16)
  // the chunk and group within the staged activations
  const int xc = (s.whole ? slab * kSlabChunks : 0) + c;
  const int xg = (s.whole ? slab * s.gsl : 0) + g;
  const int4 zero = make_int4(0, 0, 0, 0);
  int4 w[RW][2];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w[r][h] = live ? slot[2 * r * s.cs + 2 * c + h] : zero;
  if (s.gs == 16) {  // two whole groups a chunk: no shuffles
    if (!live) return;
    const bool hi = 32 * c + 16 < len;  // false for a ragged last chunk
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= s.M) break;
      const int4 x0 = sx[(2 * m) * s.cw + xc];
      const int4 x1 = sx[(2 * m + 1) * s.cw + xc];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        acc[r][m] = fold(acc[r][m], dot16(x0, w[r][0], 0),
                         sxs[m * s.gw + xg], sws[r * s.gsl + g]);
        if (hi)
          acc[r][m] = fold(acc[r][m], dot16(x1, w[r][1], 0),
                           sxs[m * s.gw + xg + 1], sws[r * s.gsl + g + 1]);
      }
    }
    return;
  }
  int part[RW][MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const bool on = live && m < s.M;
    const int4 x0 = on ? sx[(2 * m) * s.cw + xc] : zero;
    const int4 x1 = on ? sx[(2 * m + 1) * s.cw + xc] : zero;
#pragma unroll
    for (int r = 0; r < RW; ++r)
      part[r][m] = dot16(x0, w[r][0], 0) + dot16(x1, w[r][1], 0);
  }
  // a group's lanes are neighbours: sum its int32 parts exactly
  for (int off = 1; off < lpg; off <<= 1) {
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        part[r][m] += __shfl_xor_sync(0xffffffffu, part[r][m], off);
  }
  if (live && (lane & (lpg - 1)) == 0) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float wsc = sws[r * s.gsl + g];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < s.M)
          acc[r][m] = fold(acc[r][m], part[r][m], sxs[m * s.gw + xg], wsc);
    }
  }
}

// Sum V = RW * MT values over the 32 lanes, each a butterfly over lane
// offsets 16, 8, 4, 2, 1 (one fixed f32 order), in 5 - log2(V) + V - 1
// shuffles: each step keeps half the values and trades the other half.
// Value idx ends in lanes with lane >> (5 - log2(V)) == idx.
template <int V>
__device__ __forceinline__ float lane_sum(float (&v)[V], int lane) {
  int width = V;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    if (width > 1) {
      const int half = width >> 1;
      const bool upper = (lane & off) != 0;
#pragma unroll
      for (int j = 0; j < V / 2; ++j) {
        if (j < half) {
          const float send = upper ? v[j] : v[j + half];
          const float keep = upper ? v[j + half] : v[j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      width = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
  return v[0];
}

template <int MT, int RW>
__global__ void __launch_bounds__(32 * kMaxWarps)
    q8_matvec_kernel(const int8_t* __restrict__ xq,
                     const float* __restrict__ xs,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ ws, float* __restrict__ out,
                     int M, int N, int K, int gs) {
  extern __shared__ int4 staged[];
  const Shape s(M, N, K, gs, RW);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t* bars = reinterpret_cast<uint64_t*>(staged) + warp * kStages;
  if (lane == 0) {
    for (int j = 0; j < kStages; ++j) bar_init(bars + j);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  int4* sx = staged + kBar16;
  float* sxs = reinterpret_cast<float*>(sx + 2 * M * s.cw);
  int4* ring = staged + kBar16 + s.act16 + warp * kStages * s.slot16;

  const int rows = (blockDim.x >> 5) * RW;
  const int tiles = (N + rows - 1) / rows;
  const int items =
      (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      s.nslabs;
  // items run tile by tile, each tile's slabs in order: (tile, slab) of
  // the item issued next and of the item computed next
  int itile = blockIdx.x, islab = 0, ctile = blockIdx.x, cslab = 0;
  const int wrow = warp * RW;  // the warp's first row in a tile

  // kStages - 1 items of weights in flight, then the activations; item it
  // lands in slot it % kStages, in that slot's mbarrier phase it / kStages
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < items) {
      issue_item<RW>(ring + j * s.slot16, bars + j, wq, ws, s,
                     itile * rows + wrow, islab, lane);
      if (++islab == s.nslabs) islab = 0, itile += gridDim.x;
    } else {
      asm volatile("cp.async.commit_group;");
    }
  }
  stage<MT>(sx, sxs, xq, xs, s, 0);
  float acc[RW][MT];
  for (int it = 0; it < items; ++it) {
    __syncwarp();  // every lane is done with the slot refilled here
    const int j = it + kStages - 1;
    if (j < items) {
      issue_item<RW>(ring + (j % kStages) * s.slot16, bars + j % kStages, wq,
                     ws, s, itile * rows + wrow, islab, lane);
      if (++islab == s.nslabs) islab = 0, itile += gridDim.x;
    } else {
      asm volatile("cp.async.commit_group;");
    }
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    bar_wait(bars + it % kStages, (it / kStages) & 1);
    __syncwarp();  // the item's scales, copied by other lanes, are in
    if (!s.whole && s.nslabs > 1 && it > 0) {
      __syncthreads();  // every warp is done with the previous slab
      stage<MT>(sx, sxs, xq, xs, s, cslab);
    }
    if (cslab == 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
    }
    compute_item<MT, RW>(acc, ring + (it % kStages) * s.slot16, sx, sxs, s,
                         cslab, lane);
    if (++cslab < s.nslabs) continue;
    constexpr int V = RW * MT;
    constexpr int shift = V >= 32 ? 0 : V >= 16 ? 1 : V >= 8 ? 2
                          : V >= 4 ? 3 : V >= 2 ? 4 : 5;
    float v[V];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m) v[r * MT + m] = acc[r][m];
    const float total = lane_sum<V>(v, lane);
    const int idx = lane >> shift, r = idx / MT, m = idx % MT;
    const int n = ctile * rows + wrow + r;
    if ((lane & ((1 << shift) - 1)) == 0 && m < M && n < N)
      out[(size_t)m * N + n] = total;
    cslab = 0;
    ctile += gridDim.x;
  }
}

template <int MT>
int launch(const int8_t* xq, const float* xs, const int8_t* wq,
           const float* ws, float* out, int M, int N, int K, int gs,
           cudaStream_t stream) {
  constexpr int RW = MT > 2 && MT <= 8 ? 2 : 1;
  const auto kernel = q8_matvec_kernel<MT, RW>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const Shape s(M, N, K, gs, RW);
  // the widest block that still leaves a tile of rows for every SM
  int warps = kMaxWarps;
  while (warps > 1 && (N + warps * RW - 1) / (warps * RW) < sms) warps >>= 1;
  const int rows = warps * RW;
  const int tiles = (N + rows - 1) / rows;
  const size_t smem =
      sizeof(int4) * ((size_t)kBar16 + s.act16 +
                      (size_t)warps * kStages * s.slot16);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    32 * warps, smem);
  if (e != cudaSuccess) return (int)e;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = tiles < resident ? tiles : resident;
  kernel<<<blocks, 32 * warps, smem, stream>>>(xq, xs, wq, ws, out, M, N, K,
                                               gs);
  return (int)cudaGetLastError();
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
  if (M <= 1) return launch<1>(a, as, w, s, o, M, N, K, gs, st);
  if (M <= 2) return launch<2>(a, as, w, s, o, M, N, K, gs, st);
  if (M <= 4) return launch<4>(a, as, w, s, o, M, N, K, gs, st);
  if (M <= 8) return launch<8>(a, as, w, s, o, M, N, K, gs, st);
  if (M <= 16) return launch<16>(a, as, w, s, o, M, N, K, gs, st);
  return launch<32>(a, as, w, s, o, M, N, K, gs, st);
}
