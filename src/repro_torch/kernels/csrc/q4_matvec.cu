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
// M <= 32, the decode GEMV.  Each packed weight byte is used M times, so
// the bound is bytes: ~66 MB a llama2-110m decode step at M = 8, 0.0197 ms
// at 3.35 TB/s.  At these sizes (0.3 to 13.8 MB a call) a call is held back
// by latency instead: the launch, the device-memory round trips a warp
// waits for in turn, and the dependent instructions of the few warps a
// narrow layer gives each SM.  What the design does about each:
//  * Weights stream with few round trips.  A warp owns RW rows (2 for
//    M <= 8, else 1); lane l copies the 16-byte chunks (32 codes) l + 32 i
//    of each row, so one warp copy is 512 contiguous bytes, with cp.async
//    into the warp's own ring of kStages shared-memory slots.  A slot holds
//    one item, (RW rows, one slab of up to 2048 codes) with its weight
//    scales, so kStages - 1 items are in flight while the warp computes one.
//    16-byte copies need K % 32 == 0 and a 16-byte aligned wq; otherwise a
//    chunk is two 8-byte copies, and a ragged last chunk (K % 32 == 16)
//    copies its half.
//  * Every SM busy at every shape.  A block is 8, 4, 2 or 1 warps: the most
//    that still gives every SM a tile of rows (N = 768 at M = 8: 2 warps x 2
//    rows, 192 blocks on 132 SMs).  The grid is capped at what stays
//    resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and a block
//    walks tiles blockIdx.x + i * gridDim.x, so the head (N = 32000) keeps
//    every resident warp's ring full.
//  * Activations staged once per block.  After its first weight copies are
//    issued, the block loads xq (M x K int8, a slab at a time) and xs, each
//    thread one column for all M rows with up to 8 loads in flight, into
//    shared memory; every warp then reads them there, conflict-free, and
//    one activation read serves RW rows.
//  * Few instructions per code.  Staging reorders each 8 activation codes
//    to (even, odd) and stores -8 times each 16 codes' sum, so a packed
//    weight word feeds dp4a as it is: its low and high nibbles, xored with
//    8, are the codes + 8 (one mask each, no sign extension or byte
//    permutes), and the -8 * sum(x) start value takes the 8 back out.
//    A 32-code chunk lies inside one group (gs >= 32) or holds two whole
//    ones (gs = 16), so a group is one lane, two neighbouring lanes (gs = 64:
//    one shuffle) or gs / 32 lanes (log2 of it shuffles), and the shuffles
//    of all M x RW sums of a chunk issue together.  The f32 sum across lanes
//    runs once per output: a butterfly that halves the values a lane holds
//    at each step (V - 1 + 5 - log2 V shuffles for V = M x RW sums).
//  * Compute stays dp4a on the CUDA cores.  At M = 8 a step's dp4a are
//    ~6.8e6 warp instructions, ~7 us of issue at one a clock per scheduler
//    on 132 SMs, against ~0.33 ms of calls on an H100 80GB HBM3 at 700 W:
//    what a call spends beyond its round trips is the dependent chain of an
//    item, not the arithmetic rate an int8 mma.sync would raise.
// Numbers: each group's int32 sum is exact and folds into the lane's f32
// sum as acc + (part * xs) * ws with explicit rounding (no fused
// multiply-add), the plain version's product; only the order of the sum
// over groups differs (each lane's groups in order, then the butterfly
// over lane offsets 16, 8, 4, 2, 1).  Every output comes from one warp in
// a fixed order: no atomics, and the same bits from run to run.
//
// M > 32, the tiled GEMM (a chunk step's or a dense prefill's MLP, M = 2048
// to 4096 rows).  Each packed weight byte is used M times and the output is
// f32, so, as for q8_matmul, the bound is bytes: 0.0110 ms for w13 and
// 0.0035 for w2 at M = 2048, mostly the output.  The design is
// q8_matmul.cu's tensor-core mainloop with its own loader for the weights:
//  * Products on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32 (two
//    m16n8k16 for a 16-code group), A and B fragments by ldmatrix.x4 from
//    XOR-swizzled 128-code rows (16-byte chunk c of row r at c ^ (r & 7)).
//  * Copies that overlap compute: a ring of kRing = 4 slots, each one
//    128-code stage of the block's activation rows (128 bytes a row), its
//    packed weight rows (64 bytes a row, half the bytes of Q8_0) and the
//    scales of the groups that end inside it, by 16-byte and 4-byte
//    cp.async with zero fill past M, N and K.
//  * The weights unpacked once per block: there is no s8 x s4 mma (.s4
//    wants both operands 4-bit), so after a stage lands each thread turns
//    its 16-byte packed chunks into sign-extended int8 codes (unpack8:
//    a per-byte (n ^ 8) - 8, then byte permutes) in the swizzled
//    layout ldmatrix reads, into one of two unpacked buffers.  Stage kt + 1
//    is unpacked right before stage kt's products, behind the same barrier:
//    one __syncthreads a stage, two stages of copies in flight.
//  * Promotion per group in the plain version's order: when a group's last
//    k-step has run, acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(f32(p), xs),
//    ws)), no fused multiply-add; K is never split across blocks.
//  * Every SM busy: 128 x 128 tiles (8 warps of 64 x 32) where the shape
//    gives two per SM (w13 at M = 2048: 512 tiles), else 64 x 64 (4 warps
//    of 32 x 32; w2: 384 tiles, three blocks an SM); float2 stores.
// Numbers: a group's int32 sum is exact and below 2^24 (512 * 127 * 8), so
// f32(p) is exact, and every output comes from one thread folding the
// groups in order: bitwise ref.ref_q4_matvec, the same bits run to run.
// Shapes whose packed rows are not whole 16-byte chunks (K % 32 == 16) or
// whose weights are only 8-byte aligned take the first port's dp4a kernel:
// a 64 x 64 tile of 4 x 4 micro-tiles on the CUDA cores, one group staged
// at a time, the same fold, so bitwise too; the C entry reports that route.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatvecMaxRows = 32;
constexpr int kMaxWarps = 8;
constexpr int kSlabChunks = 64;                  // 32-code chunks a slab
constexpr int kSlabCodes = 32 * kSlabChunks;     // 2048
constexpr int kChunksPerLane = kSlabChunks / 32;
constexpr int kStages = 4;                       // items in flight a warp
constexpr int kStageBatch = 8;                   // loads in flight a thread
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

// 16 codes of one half chunk: activations de-interleaved (even codes, odd
// codes of each 8) against the unsigned nibbles u = code + 8 of two packed
// words, from corr = -8 * (sum of the 16 activation codes):
// sum x * code = sum x * u - 8 * sum x, exact in int32
__device__ __forceinline__ int dot16(const int4& x, unsigned int w0,
                                     unsigned int w1, int corr) {
  int s = __dp4a(x.x, (int)((w0 & 0x0F0F0F0Fu) ^ 0x08080808u), corr);
  s = __dp4a(x.y, (int)(((w0 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u), s);
  s = __dp4a(x.z, (int)((w1 & 0x0F0F0F0Fu) ^ 0x08080808u), s);
  return __dp4a(x.w, (int)(((w1 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u), s);
}

// acc + (part * xs) * ws, rounded at each step as the plain version is
__device__ __forceinline__ float fold(float acc, int part, float xs,
                                      float ws) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn((float)part, xs), ws));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* smem, const void* gmem) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
               "l"(gmem), "n"(BYTES));
}

// Sizes of one launch, and the shared memory layout (in 16-byte units):
// the staged activation slab, then each warp's ring of kStages slots.
struct Shape {
  int M, N, K, gs, lg, G;
  int C;       // 32-code chunks of a row (the last may hold 16 codes)
  int cs;      // chunks of a slab: min(kSlabChunks, C)
  int cpl;     // chunks a lane takes from one row of a slab: 1 or 2
  int gsl;     // groups of a slab
  int nslabs;
  int act16;   // 16-byte units of the staged activations
  int slot16;  // 16-byte units of one ring slot
  bool wide;   // 16-byte weight copies (K % 32 == 0, wq 16-byte aligned)

  __host__ __device__ Shape(int M_, int N_, int K_, int gs_, int rw,
                            bool wide_)
      : M(M_), N(N_), K(K_), gs(gs_), wide(wide_) {
    lg = 0;
    while ((1 << lg) < gs) ++lg;
    G = K >> lg;
    C = (K + 31) >> 5;
    cs = C < kSlabChunks ? C : kSlabChunks;
    cpl = (cs + 31) >> 5;
    gsl = (K < kSlabCodes ? K : kSlabCodes) >> lg;
    nslabs = (K + kSlabCodes - 1) / kSlabCodes;
    // x planes [M][2][cs] int4, corrections [M][cs] int2, xs [M][gsl] f32
    act16 = 2 * M * cs + (M * cs + 1) / 2 + (M * gsl + 3) / 4;
    // weights [rw][cpl][32] int4, then ws [rw][gsl] f32
    slot16 = rw * cpl * 32 + (rw * gsl + 3) / 4;
  }
};

// Copy slab `slab` of xq and xs into shared memory.  Row m's chunk c
// lands in two planes, half h of 16 codes at sx[(2m + h) * cs + c], its
// words reordered to (even codes 0-6, odd 1-7, even 8-14, odd 9-15) so
// each meets one packed weight word's low and high nibbles; scorr[m * cs +
// c] holds -8 times each half's code sum.  A ragged last half is zero.
// A thread takes one column of halves (or of groups) for every row m at
// once, up to kStageBatch loads in flight before it uses the first.
template <int MT>
__device__ __forceinline__ void stage(int4* sx, int2* scorr, float* sxs,
                                      const int8_t* __restrict__ xq,
                                      const float* __restrict__ xs,
                                      const Shape& s, int slab) {
  const int codes0 = slab * kSlabCodes;
  const int len = min(kSlabCodes, s.K - codes0);
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
      if (m < s.M) sxs[m * s.gsl + g] = v[m];
  }
  for (int j = threadIdx.x; j < halves; j += blockDim.x) {
    const bool real = 16 * j < len;
    int4* dst = sx + (j & 1) * s.cs + (j >> 1);
    int* corr = reinterpret_cast<int*>(scorr) + 2 * (j >> 1) + (j & 1);
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
      for (int u = 0; u < kStageBatch && m0 + u < MT; ++u) {
        const int m = m0 + u;
        if (m >= s.M) break;
        int sum = __dp4a(a[u].x, 0x01010101, 0);
        sum = __dp4a(a[u].y, 0x01010101, sum);
        sum = __dp4a(a[u].z, 0x01010101, sum);
        sum = __dp4a(a[u].w, 0x01010101, sum);
        dst[2 * m * s.cs] = make_int4((int)__byte_perm(a[u].x, a[u].y, 0x6420),
                                      (int)__byte_perm(a[u].x, a[u].y, 0x7531),
                                      (int)__byte_perm(a[u].z, a[u].w, 0x6420),
                                      (int)__byte_perm(a[u].z, a[u].w, 0x7531));
        corr[2 * m * s.cs] = -8 * sum;
      }
    }
  }
  __syncthreads();
}

// Start copying rows n0 .. n0 + RW - 1 of slab `slab` (weights and their
// scales) into a ring slot; one cp.async group per item.  Each lane copies
// the weight chunks it will read itself.
template <int RW>
__device__ __forceinline__ void issue_item(int4* slot,
                                           const int8_t* __restrict__ wq,
                                           const float* __restrict__ ws,
                                           const Shape& s, int n0, int slab,
                                           int lane) {
  const int kh = s.K >> 1;
  float* sws = reinterpret_cast<float*>(slot + RW * s.cpl * 32);
  const int groups = min(kSlabCodes, s.K - slab * kSlabCodes) >> s.lg;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int n = n0 + r;
    if (n >= s.N) break;  // uniform across the warp
    const int8_t* row = wq + (size_t)n * kh;
    for (int i = 0; i < s.cpl; ++i) {
      const int c = slab * kSlabChunks + 32 * i + lane;
      if (c >= s.C) break;
      int4* dst = slot + (r * s.cpl + i) * 32 + lane;
      if (s.wide) {
        cp_async16(dst, row + 16 * c);
      } else {  // 8-byte aligned rows, or a ragged last chunk
        cp_async_ca<8>(dst, row + 16 * c);
        if (16 * c + 8 < kh)
          cp_async_ca<8>(reinterpret_cast<int8_t*>(dst) + 8, row + 16 * c + 8);
        else
          reinterpret_cast<int2*>(dst)[1] = make_int2(0, 0);
      }
    }
    for (int g = lane; g < groups; g += 32)
      cp_async_ca<4>(sws + r * s.gsl + g,
                     ws + (size_t)n * s.G + (slab * kSlabCodes >> s.lg) + g);
  }
  asm volatile("cp.async.commit_group;");
}

// One warp's RW rows over one slab: every group of the lane's chunks
// folds into acc[r][m].
template <int MT, int RW>
__device__ __forceinline__ void compute_item(float (&acc)[RW][MT],
                                             const int4* slot,
                                             const int4* sx,
                                             const int2* scorr,
                                             const float* sxs, const Shape& s,
                                             int slab, int lane) {
  const float* sws = reinterpret_cast<const float*>(slot + RW * s.cpl * 32);
  const int len = min(kSlabCodes, s.K - slab * kSlabCodes);
  const int csl = (len + 31) >> 5;  // chunks of this slab
  const int lpg = s.gs >> 5;         // lanes a group (0 when gs = 16)
#pragma unroll
  for (int i = 0; i < kChunksPerLane; ++i) {
    if (32 * i >= csl) break;  // uniform: no lane has a chunk here
    const int c = 32 * i + lane;
    const bool live = c < csl;
    const int g = (32 * c) >> s.lg;  // group within the slab
    uint4 w[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int4 v = live ? slot[(r * s.cpl + i) * 32 + lane]
                          : make_int4(0, 0, 0, 0);
      w[r] = make_uint4(v.x, v.y, v.z, v.w);
    }
    if (s.gs == 16) {  // two whole groups a chunk: no shuffles
      const bool hi = 32 * c + 16 < len;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= s.M || !live) break;
        const int4 x0 = sx[(2 * m) * s.cs + c];
        const int4 x1 = sx[(2 * m + 1) * s.cs + c];
        const int2 cr = scorr[m * s.cs + c];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int p0 = dot16(x0, w[r].x, w[r].y, cr.x);
          acc[r][m] = fold(acc[r][m], p0, sxs[m * s.gsl + g],
                           sws[r * s.gsl + g]);
          if (hi) {
            const int p1 = dot16(x1, w[r].z, w[r].w, cr.y);
            acc[r][m] = fold(acc[r][m], p1, sxs[m * s.gsl + g + 1],
                             sws[r * s.gsl + g + 1]);
          }
        }
      }
      continue;
    }
    int part[RW][MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int4 zero = make_int4(0, 0, 0, 0);
      const bool on = live && m < s.M;
      const int4 x0 = on ? sx[(2 * m) * s.cs + c] : zero;
      const int4 x1 = on ? sx[(2 * m + 1) * s.cs + c] : zero;
      const int2 cr = on ? scorr[m * s.cs + c] : make_int2(0, 0);
#pragma unroll
      for (int r = 0; r < RW; ++r)
        part[r][m] = dot16(x0, w[r].x, w[r].y, cr.x) +
                     dot16(x1, w[r].z, w[r].w, cr.y);
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
            acc[r][m] = fold(acc[r][m], part[r][m], sxs[m * s.gsl + g], wsc);
      }
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
    q4_matvec_kernel(const int8_t* __restrict__ xq,
                     const float* __restrict__ xs,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ ws, float* __restrict__ out,
                     int M, int N, int K, int gs, int wide) {
  extern __shared__ int4 staged[];
  const Shape s(M, N, K, gs, RW, wide != 0);
  int4* sx = staged;
  int2* scorr = reinterpret_cast<int2*>(sx + 2 * M * s.cs);
  float* sxs = reinterpret_cast<float*>(scorr + M * s.cs);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4* ring = staged + s.act16 + warp * kStages * s.slot16;

  const int rows = (blockDim.x >> 5) * RW;
  const int tiles = (N + rows - 1) / rows;
  const int items =
      (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      s.nslabs;
  // items run tile by tile, each tile's slabs in order: (tile, slab) of
  // the item issued next and of the item computed next
  int itile = blockIdx.x, islab = 0, ctile = blockIdx.x, cslab = 0;
  const int wrow = warp * RW;  // the warp's first row in a tile

  // kStages - 1 items of weights in flight, then the activations
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < items) {
      issue_item<RW>(ring + j * s.slot16, wq, ws, s, itile * rows + wrow,
                     islab, lane);
      if (++islab == s.nslabs) islab = 0, itile += gridDim.x;
    } else {
      asm volatile("cp.async.commit_group;");
    }
  }
  stage<MT>(sx, scorr, sxs, xq, xs, s, 0);
  float acc[RW][MT];
  for (int it = 0; it < items; ++it) {
    __syncwarp();  // every lane is done with the slot refilled here
    const int j = it + kStages - 1;
    if (j < items) {
      issue_item<RW>(ring + (j % kStages) * s.slot16, wq, ws, s,
                     itile * rows + wrow, islab, lane);
      if (++islab == s.nslabs) islab = 0, itile += gridDim.x;
    } else {
      asm volatile("cp.async.commit_group;");
    }
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncwarp();  // the item's scales, copied by other lanes, are in
    if (s.nslabs > 1 && it > 0) {
      __syncthreads();  // every warp is done with the previous slab
      stage<MT>(sx, scorr, sxs, xq, xs, s, cslab);
    }
    if (cslab == 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
    }
    compute_item<MT, RW>(acc, ring + (it % kStages) * s.slot16, sx, scorr,
                         sxs, s, cslab, lane);
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

// M > 32 where the tensor cores cannot take the shape: K % 32 == 16, or
// weights only 8-byte aligned
__global__ void q4_dp4a_kernel(const int8_t* __restrict__ xq,
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

int launch_dp4a(const int8_t* xq, const float* xs, const int8_t* wq,
                const float* ws, float* out, int M, int N, int K, int gs,
                cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  const size_t smem = 2 * kTile * (gs / 4 + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        q4_dp4a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  q4_dp4a_kernel<<<grid, kThreads, smem, stream>>>(xq, xs, wq, ws, out, M, N,
                                                   K, gs);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M > 32 on the tensor cores (the PTX helpers are q8_matmul.cu's)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBK = 128;           // codes of K a stage: a 128-byte line
constexpr int kChunks = kBK / 16;  // 16-byte chunks of a staged int8 row
constexpr int kPacked = kBK / 32;  // 16-byte chunks of a staged packed row
constexpr int kRing = 4;           // two stages in flight, one unpacked and
                                   // one multiplied

// groups that can end inside one stage: 8 of 16 codes, else at most 4
__host__ __device__ constexpr int ends(bool half) {
  return half ? kBK / 16 : kBK / 32;
}

// where 16-byte chunk c of staged row r lies: the 8 rows an ldmatrix reads
// hit 8 distinct 16-byte bank groups
__device__ __forceinline__ int swizzle(int r, int c) { return c ^ (r & 7); }

// byte offsets inside one ring slot of a BM x BN tile
template <int BM, int BN, int kEnds>
struct Slot {
  static constexpr int kA = 0;                      // [BM][kBK] int8
  static constexpr int kP = kA + BM * kBK;          // [BN][kBK / 2] packed
  static constexpr int kSx = kP + BN * kBK / 2;     // [kEnds][BM] f32
  static constexpr int kSw = kSx + kEnds * BM * 4;  // [kEnds][BN] f32
  static constexpr int kBytes = kSw + kEnds * BN * 4;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k16(int (&d)[4], uint32_t a0, uint32_t a1,
                                        uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// A block of WM x WN warps, each a warp tile of MT m16 by NT n8 fragments.
// kHalf: 16-code groups, whose k-steps are m16n8k16.
template <int WM, int WN, int MT, int NT, bool kHalf, int kMinBlocks>
__global__ void __launch_bounds__(WM* WN * 32, kMinBlocks)
    q4_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int8_t* __restrict__ wq, const float* __restrict__ ws,
                  float* __restrict__ out, int M, int N, int K, int gs) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  using S = Slot<BM, BN, ends(kHalf)>;
  static_assert(MT % 2 == 0 && NT % 4 == 0, "fragment pairs / quads");
  static_assert(BM * kChunks % kThreads == 0 && BN * kPacked % kThreads == 0,
                "whole copy rounds");
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint8_t* const unpacked = smem + kRing * S::kBytes;  // 2 x [BN][kBK] int8
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = warp / WN * MT * 16, wn0 = warp % WN * NT * 8;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int G = K / gs, KT = (K + kBK - 1) / kBK, kh = K / 2;

  // stage kt into ring slot kt % kRing: codes k0 .. k0 + kBK - 1 of the
  // block's activation rows and packed weight rows, and the scales of the
  // groups g0 .. g0 + ends - 1 that end inside them
  auto load = [&](int kt) {
    const uint32_t st = sbase + (kt % kRing) * S::kBytes;
    const int k0 = kt * kBK;
#pragma unroll
    for (int it = 0; it < BM * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads, r = i / kChunks, c = i % kChunks;
      const int row = m0 + r, k = k0 + 16 * c;
      const bool ok = row < M && k < K;
      cp_async16(st + S::kA + r * kBK + (swizzle(r, c) << 4),
                 ok ? xq + (size_t)row * K + k : xq, ok ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < BN * kPacked / kThreads; ++it) {
      const int i = tid + it * kThreads, r = i / kPacked, c = i % kPacked;
      const int row = n0 + r, k = k0 + 32 * c;  // 32 codes a packed chunk
      const bool ok = row < N && k < K;
      cp_async16(st + S::kP + r * (kBK / 2) + 16 * c,
                 ok ? wq + (size_t)row * kh + k / 2 : wq, ok ? 16 : 0);
    }
    const int g0 = k0 / gs, nends = min(k0 + kBK, K) / gs - g0;
    for (int i = tid; i < nends * (BM + BN); i += kThreads) {
      const int j = i / (BM + BN), r = i - j * (BM + BN);
      const bool a = r < BM;
      const int row = a ? m0 + r : n0 + r - BM;
      const bool ok = row < (a ? M : N);
      const float* src = a ? xs : ws;
      if (ok) src += (size_t)row * G + g0 + j;
      cp_async4(st + (a ? S::kSx + 4 * (j * BM + r)
                        : S::kSw + 4 * (j * BN + r - BM)),
                src, ok ? 4 : 0);
    }
  };

  // the packed weights of stage kt -> int8 codes in unpacked buffer kt & 1,
  // chunk c of row r at swizzle(r, c); one 16-byte packed chunk (32 codes)
  // a thread a round
  auto unpack = [&](int kt) {
    const uint8_t* p = smem + (kt % kRing) * S::kBytes + S::kP;
    uint8_t* b = unpacked + (kt & 1) * BN * kBK;
#pragma unroll
    for (int it = 0; it < BN * kPacked / kThreads; ++it) {
      const int i = tid + it * kThreads, r = i / kPacked, c = i % kPacked;
      const uint4 w =
          *reinterpret_cast<const uint4*>(p + r * (kBK / 2) + 16 * c);
      int4 lo, hi;
      unpack8(w.x, lo.x, lo.y);
      unpack8(w.y, lo.z, lo.w);
      unpack8(w.z, hi.x, hi.y);
      unpack8(w.w, hi.z, hi.w);
      *reinterpret_cast<int4*>(b + r * kBK + (swizzle(r, 2 * c) << 4)) = lo;
      *reinterpret_cast<int4*>(b + r * kBK + (swizzle(r, 2 * c + 1) << 4)) =
          hi;
    }
  };

  int acc[MT][NT][4];
  float facc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] = 0;
        facc[mt][nt][i] = 0.f;
      }

  // fold the finished group's int32 sums; sx / sw: its scales in the stage
  auto promote = [&](const float* sx, const float* sw) {
    float xr[MT][2];
    float2 wc[NT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      xr[mt][0] = sx[wm0 + mt * 16 + (lane >> 2)];
      xr[mt][1] = sx[wm0 + mt * 16 + (lane >> 2) + 8];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      wc[nt] = *reinterpret_cast<const float2*>(sw + wn0 + nt * 8 +
                                                2 * (lane & 3));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          facc[mt][nt][i] = __fadd_rn(
              facc[mt][nt][i],
              __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][i]),
                                  xr[mt][i >> 1]),
                        (i & 1) ? wc[nt].y : wc[nt].x));
          acc[mt][nt][i] = 0;
        }
  };

  // ldmatrix rows: every row a lane addresses is lane & 7 modulo 8, so
  // chunk c lies at swizzle(lane, c)
  const int a_k32 = (wm0 + (lane & 15)) * kBK;              // + mt * 16 rows
  const int a_k16 = (wm0 + (lane & 15) + (lane >> 4) * 16) * kBK;
  const int b_k32 = (wn0 + (lane & 7) + (lane >> 4) * 8) * kBK;  // + nt * 8
  const int b_k16 = (wn0 + lane) * kBK;
  const int a_hi = lane >> 4, b_hi = lane >> 3 & 1;  // k32: second 16 codes

  // one k16 step on 16-code chunk c of the stage
  auto step16 = [&](uint32_t sa, uint32_t sb, int c) {
    uint32_t af[MT][2], bf[NT];
#pragma unroll
    for (int mt = 0; mt < MT; mt += 2) {
      uint32_t r[4];
      ldsm_x4(r, sa + a_k16 + mt * 16 * kBK + (swizzle(lane, c) << 4));
      af[mt][0] = r[0];
      af[mt][1] = r[1];
      af[mt + 1][0] = r[2];
      af[mt + 1][1] = r[3];
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 4) {
      uint32_t r[4];
      ldsm_x4(r, sb + b_k16 + nt * 8 * kBK + (swizzle(lane, c) << 4));
#pragma unroll
      for (int q = 0; q < 4; ++q) bf[nt + q] = r[q];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_k16(acc[mt][nt], af[mt][0], af[mt][1], bf[nt]);
  };

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < KT) load(s);
    asm volatile("cp.async.commit_group;");
  }
  cp_async_wait<kRing - 2>();
  __syncthreads();  // stage 0 landed
  unpack(0);
  int g = 0, kg = 0;  // the group being summed, and its codes summed so far
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kRing - 3>();
    // stage kt + 1 landed, stage kt is unpacked, and every warp is done
    // with stage kt - 1: its slot and its unpacked buffer are free
    __syncthreads();
    if (kt + kRing - 1 < KT) load(kt + kRing - 1);
    asm volatile("cp.async.commit_group;");
    if (kt + 1 < KT) unpack(kt + 1);
    const int off = (kt % kRing) * S::kBytes;
    const uint32_t sa = sbase + off + S::kA;
    const uint32_t sb = sbase + kRing * S::kBytes + (kt & 1) * BN * kBK;
    const float* sx = reinterpret_cast<const float*>(smem + off + S::kSx);
    const float* sw = reinterpret_cast<const float*>(smem + off + S::kSw);
    const int gstage = g;
    // after `codes` more codes of group g: promote it if it is complete
    auto advance = [&](int codes) {
      kg += codes;
      if (kg == gs) {
        promote(sx + (g - gstage) * BM, sw + (g - gstage) * BN);
        ++g;
        kg = 0;
      }
    };
#pragma unroll
    for (int p = 0; p < kChunks / 2; ++p) {
      const int kk = kt * kBK + 32 * p;
      if (kk >= K) break;
      if (!kHalf) {
        uint32_t af[MT][4], bf[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(af[mt], sa + a_k32 + mt * 16 * kBK +
                              (swizzle(lane, 2 * p + a_hi) << 4));
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t r[4];
          ldsm_x4(r, sb + b_k32 + nt * 8 * kBK +
                         (swizzle(lane, 2 * p + b_hi) << 4));
          bf[nt][0] = r[0];
          bf[nt][1] = r[1];
          bf[nt + 1][0] = r[2];
          bf[nt + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_k32(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
        advance(32);
      } else {
        // two 16-code groups: two k16 steps, a promotion after each
        step16(sa, sb, 2 * p);
        advance(16);
        step16(sa, sb, 2 * p + 1);
        advance(16);
      }
    }
  }
  cp_async_wait<0>();

  const bool pairs = (N & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + mt * 16 + (lane >> 2) + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn0 + nt * 8 + 2 * (lane & 3);
        float* o = out + (size_t)m * N + n;
        const float v0 = facc[mt][nt][2 * h], v1 = facc[mt][nt][2 * h + 1];
        if (pairs && n + 1 < N) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (n < N) o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
    }
}

template <int WM, int WN, int MT, int NT, bool kHalf, int kMinBlocks>
int launch_mma(const int8_t* xq, const float* xs, const int8_t* wq,
               const float* ws, float* out, int M, int N, int K, int gs,
               cudaStream_t stream) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int smem =
      kRing * Slot<BM, BN, ends(kHalf)>::kBytes + 2 * BN * kBK;
  auto kernel = q4_mma_kernel<WM, WN, MT, NT, kHalf, kMinBlocks>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(xq, xs, wq, ws, out, M, N, K,
                                               gs);
  return (int)cudaGetLastError();
}

template <int WM, int WN, int MT, int NT, int kMinBlocks>
int launch_tile(const int8_t* xq, const float* xs, const int8_t* wq,
                const float* ws, float* out, int M, int N, int K, int gs,
                cudaStream_t stream) {
  if (gs == 16)
    return launch_mma<WM, WN, MT, NT, true, kMinBlocks>(xq, xs, wq, ws, out,
                                                        M, N, K, gs, stream);
  return launch_mma<WM, WN, MT, NT, false, kMinBlocks>(xq, xs, wq, ws, out, M,
                                                       N, K, gs, stream);
}

}  // namespace tc

template <int MT>
int launch_matvec(const int8_t* xq, const float* xs, const int8_t* wq,
                  const float* ws, float* out, int M, int N, int K, int gs,
                  cudaStream_t stream) {
  constexpr int RW = MT <= 8 ? 2 : 1;
  const auto kernel = q4_matvec_kernel<MT, RW>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const bool wide = K % 32 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const Shape s(M, N, K, gs, RW, wide);
  // the widest block that still leaves a tile of rows for every SM
  int warps = kMaxWarps;
  while (warps > 1 && (N + warps * RW - 1) / (warps * RW) < sms) warps >>= 1;
  const int rows = warps * RW;
  const int tiles = (N + rows - 1) / rows;
  const size_t smem =
      sizeof(int4) * ((size_t)s.act16 + (size_t)warps * kStages * s.slot16);
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
  q4_matvec_kernel<MT, RW><<<blocks, 32 * warps, smem, stream>>>(
      xq, xs, wq, ws, out, M, N, K, gs, (int)wide);
  return (int)cudaGetLastError();
}

}  // namespace

// xq (M, K) int8, xs (M, K/gs) f32, wq (N, K/2) int8 packed, ws (N, K/gs)
// f32, out (M, N) f32; all contiguous, xq 16-byte and wq 8-byte aligned,
// K % 16 == 0, gs in {16, 32, ..., 512} dividing K (the wrapper checks).
// M > 32 runs on the tensor cores where K % 32 == 0 and wq is 16-byte
// aligned, on the dp4a kernel otherwise; *dp4a tells the caller which one
// ran (1: the dp4a kernel; always 0 for the GEMV, M <= 32).
extern "C" int q4_matvec(const void* xq, const void* xs, const void* wq,
                         const void* ws, void* out, int M, int N, int K,
                         int gs, int* dp4a, void* stream) {
  const int8_t* a = static_cast<const int8_t*>(xq);
  const float* as = static_cast<const float*>(xs);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *dp4a = M > kMatvecMaxRows &&
          (K % 32 || reinterpret_cast<uintptr_t>(wq) % 16);
  if (*dp4a) return launch_dp4a(a, as, w, s, o, M, N, K, gs, st);
  if (M > kMatvecMaxRows) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    // 128 x 128 tiles only when they still give every SM two of them
    const long big = (long)((M + 127) / 128) * ((N + 127) / 128);
    if (big >= 2L * sms)
      return tc::launch_tile<2, 4, 4, 4, 1>(a, as, w, s, o, M, N, K, gs, st);
    return tc::launch_tile<2, 2, 2, 4, 3>(a, as, w, s, o, M, N, K, gs, st);
  }
  if (M <= 1) return launch_matvec<1>(a, as, w, s, o, M, N, K, gs, st);
  if (M <= 2) return launch_matvec<2>(a, as, w, s, o, M, N, K, gs, st);
  if (M <= 4) return launch_matvec<4>(a, as, w, s, o, M, N, K, gs, st);
  if (M <= 8) return launch_matvec<8>(a, as, w, s, o, M, N, K, gs, st);
  if (M <= 16) return launch_matvec<16>(a, as, w, s, o, M, N, K, gs, st);
  return launch_matvec<32>(a, as, w, s, o, M, N, K, gs, st);
}
