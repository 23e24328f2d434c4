// Grouped Q8_0 matrix product for prefill (M > 32 activation rows).
//
// Replaces src/repro/kernels/q8_matmul.py::q8_matmul_pallas (pallas_call at
// q8_matmul.py:92).  Same function as q8_matvec:
//
//     out[m, n] = fold over g = 0..G-1 in order:
//                 acc + (f32(sum_{k in g} int32(xq[m, k] * wq[n, k]))
//                        * xs[m, g]) * ws[n, g]
//
// What bounds it on an H100: at a chunk step (M = 2048 rows) each weight
// byte is used 2048 times, so the int8 products alone would be bound by the
// tensor cores' rate; but the output is f32, and writing it (33.5 MB of
// w13's 38.6 MB) makes the bound bytes: 0.0115 ms for w13, 0.0036 for w2.
//
// Design (the tensor-core path, taken whenever the group is a multiple of
// 16 and both code arrays are 16-byte aligned -- llama2-110m's group 64
// always is):
//  * Products on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, and
//    m16n8k16 for a 16-code remainder of a group (groups 16, 48, 80, ...).
//    xq (M, K) and wq (N, K) are both K-contiguous, which is mma's
//    .row.col layout: A and B fragments come straight from ldmatrix.x4 on
//    the staged rows (a 16 x 32 A fragment is one x4; one x4 gives two n8
//    B fragments).
//  * Copies that overlap compute: a ring of kStages = 3 shared-memory
//    stages, each kBK = 128 codes of K (one 128-byte line of every row) for
//    the block's A and B rows plus the scales of every group that ends
//    inside those codes (at most 8), filled by 16-byte (codes) and 4-byte
//    (scales) cp.async with zero fill past M, N and K.  One __syncthreads
//    per stage.  16-byte chunk c of staged row r lies at c ^ (r & 7), so the
//    8 rows of every ldmatrix hit 8 distinct bank groups.  (On an H100, 64
//    codes a stage were slower for w13, whatever the ring depth.)
//  * Promotion per group: when a group's last k-step has run, each thread
//    folds its int32 fragment sums into f32 registers as
//    __fadd_rn(acc, __fmul_rn(__fmul_rn(p, sx), sw)) -- the plain version's
//    product and order, no fused multiply-add -- and restarts the int32
//    sums.  Groups never share an int32 sum, because their scales differ,
//    and K is never split across blocks, which would change the fold
//    order.
//  * Every SM busy: a 128 x 128 tile (8 warps of 64 x 32) when the shape
//    gives at least two tiles per SM (w13 at M = 2048: 512 tiles), else a
//    64 x 64 tile (4 warps of 32 x 32; w2 at M = 2048: 384 tiles, a dense
//    prefill of 600 rows x 4096: 640), several blocks an SM.
//  * Stores: each thread writes its fragment's column pairs as float2, so
//    the 4 lanes of a fragment row fill one whole 32-byte sector.
// What holds it back (on an H100 80GB HBM3 at 700 W): the products and
// their promotion more than the copies -- taking the in-loop copies out
// saves less than taking the promotion out, and the f32 stores of the
// epilogue do not overlap the next tile's work.  (Int32 sums started at the
// bits of 1.5 * 2^23, so that f32(p) is one subtraction and not an I2F, made
// the chunk step only 0.8% faster.)  The step after this is
// wgmma, whose products run while the warpgroup promotes the previous group
// (a first version of that, TMA-fed with a producer warp, was no faster:
// its mbarrier hand-offs and one-warp scale copies cost what the overlap
// saved).
// Numbers: each group's int32 sum is exact and below 2^24 for groups up to
// 512, so f32(p) is exact and the output is bitwise the plain version's
// (ref.ref_q8_matmul).  Every output comes from one thread in a fixed order:
// the same bits from run to run.
//
// Other shapes (a group that is not a multiple of 16, or codes that are not
// 16-byte aligned; the wrapper takes any group that is a multiple of 4 and
// 4-byte aligned codes) take the first port's dp4a kernel: a 64 x 64 tile
// of 4 x 4 micro-tiles on the CUDA cores, one group staged at a time, with
// the same fold, so it is bitwise the plain version's too.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// tensor-core path
// ---------------------------------------------------------------------------

constexpr int kBK = 128;           // codes of K a stage: a 128-byte line
constexpr int kChunks = kBK / 16;  // 16-byte chunks of a staged row
constexpr int kStages = 3;         // ring depth
constexpr int kEnds = kBK / 16;    // groups that can end inside one stage

// where 16-byte chunk c of staged row r lies: the 8 rows an ldmatrix reads
// hit 8 distinct 16-byte bank groups
__device__ __forceinline__ int swizzle(int r, int c) { return c ^ (r & 7); }

// byte offsets inside one stage of a BM x BN tile
template <int BM, int BN>
struct Stage {
  static constexpr int kA = 0;                      // [BM][kBK] int8
  static constexpr int kB = kA + BM * kBK;          // [BN][kBK] int8
  static constexpr int kSx = kB + BN * kBK;         // [kEnds][BM] f32
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
// kHalf: the group is an odd multiple of 16, so some k-steps are m16n8k16.
template <int WM, int WN, int MT, int NT, bool kHalf, int kMinBlocks>
__global__ void __launch_bounds__(WM* WN * 32, kMinBlocks)
    q8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int8_t* __restrict__ wq, const float* __restrict__ ws,
                  float* __restrict__ out, int M, int N, int K, int gs) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  using S = Stage<BM, BN>;
  static_assert(MT % 2 == 0 && NT % 4 == 0, "fragment pairs / quads");
  static_assert((BM + BN) * kChunks % kThreads == 0, "whole copy rounds");
  static_assert(BM * kChunks % kThreads == 0, "A and B in separate rounds");
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = warp / WN * MT * 16, wn0 = warp % WN * NT * 8;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int G = K / gs, KT = (K + kBK - 1) / kBK;

  // stage kt: codes k0 .. k0 + kBK - 1 of the block's rows, and the scales of
  // the groups g0 .. g0 + ends - 1 that end inside them
  auto load = [&](int kt) {
    const uint32_t st = sbase + (kt % kStages) * S::kBytes;
    const int k0 = kt * kBK;
#pragma unroll
    for (int it = 0; it < (BM + BN) * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const bool a = i < BM * kChunks;  // uniform over the round
      const int r = (a ? i : i - BM * kChunks) / kChunks, c = i % kChunks;
      const int row = (a ? m0 : n0) + r, k = k0 + 16 * c;
      const bool ok = row < (a ? M : N) && k < K;
      const int8_t* src = a ? xq : wq;
      if (ok) src += (size_t)row * K + k;
      cp_async16(st + (a ? S::kA : S::kB) + r * kBK + (swizzle(r, c) << 4),
                 src, ok ? 16 : 0);
    }
    const int g0 = k0 / gs, ends = min(k0 + kBK, K) / gs - g0;
    for (int i = tid; i < ends * (BM + BN); i += kThreads) {
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
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s);
    asm volatile("cp.async.commit_group;");
  }
  int g = 0, kg = 0;  // the group being summed, and its codes summed so far
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    if (kt + kStages - 1 < KT) load(kt + kStages - 1);
    asm volatile("cp.async.commit_group;");
    const int off = (kt % kStages) * S::kBytes;
    const uint32_t sa = sbase + off + S::kA, sb = sbase + off + S::kB;
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
      if (!kHalf || gs - kg != 16) {
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
        // the group ends 16 codes in: two k16 steps, a promotion between
        step16(sa, sb, 2 * p);
        advance(16);
        if (kk + 16 < K) {
          step16(sa, sb, 2 * p + 1);
          advance(16);
        }
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
  constexpr int smem = kStages * Stage<BM, BN>::kBytes;
  auto kernel = q8_mma_kernel<WM, WN, MT, NT, kHalf, kMinBlocks>;
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
  if (gs % 32)
    return launch_mma<WM, WN, MT, NT, true, kMinBlocks>(xq, xs, wq, ws, out,
                                                        M, N, K, gs, stream);
  return launch_mma<WM, WN, MT, NT, false, kMinBlocks>(xq, xs, wq, ws, out, M,
                                                       N, K, gs, stream);
}

// ---------------------------------------------------------------------------
// dp4a path: groups that are not a multiple of 16, or unaligned codes
// ---------------------------------------------------------------------------

constexpr int kTile = 64;
constexpr int kThreads = 256;

__global__ void q8_dp4a_kernel(const int8_t* __restrict__ xq,
                               const float* __restrict__ xs,
                               const int8_t* __restrict__ wq,
                               const float* __restrict__ ws,
                               float* __restrict__ out, int M, int N, int K,
                               int gs) {
  extern __shared__ int smem_w[];
  const int wpr = gs >> 2;        // 4-byte words of one row's group slice
  const int ldw = wpr + 1;        // padded row stride in words
  int* As = smem_w;               // [kTile][ldw]
  int* Bs = smem_w + kTile * ldw; // [kTile][ldw]
  const int G = K / gs;
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
      const size_t col = (size_t)g * gs + 4 * c;
      const int m = m0 + r, n = n0 + r;
      As[r * ldw + c] =
          m < M ? __ldg(reinterpret_cast<const int*>(xq + (size_t)m * K + col))
                : 0;
      Bs[r * ldw + c] =
          n < N ? __ldg(reinterpret_cast<const int*>(wq + (size_t)n * K + col))
                : 0;
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
        q8_dp4a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  q8_dp4a_kernel<<<grid, kThreads, smem, stream>>>(xq, xs, wq, ws, out, M, N,
                                                   K, gs);
  return (int)cudaGetLastError();
}

}  // namespace

// xq (M, K) int8, xs (M, K/gs) f32, wq (N, K) int8, ws (N, K/gs) f32,
// out (M, N) f32; all contiguous and 4-byte aligned, gs % 4 == 0 dividing K
// (the wrapper checks).  Groups that are a multiple of 16 with 16-byte
// aligned codes run on the tensor cores, the rest on the dp4a kernel;
// *dp4a tells the caller which one ran (1: the dp4a kernel).
extern "C" int q8_matmul(const void* xq, const void* xs, const void* wq,
                         const void* ws, void* out, int M, int N, int K,
                         int gs, int* dp4a, void* stream) {
  const auto* a = static_cast<const int8_t*>(xq);
  const auto* b = static_cast<const int8_t*>(wq);
  const auto* sa = static_cast<const float*>(xs);
  const auto* sb = static_cast<const float*>(ws);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  *dp4a = gs % 16 || reinterpret_cast<uintptr_t>(xq) % 16 ||
          reinterpret_cast<uintptr_t>(wq) % 16;
  if (*dp4a) return launch_dp4a(a, sa, b, sb, o, M, N, K, gs, s);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // 128 x 128 tiles only when they still give every SM two of them
  const long big = (long)((M + 127) / 128) * ((N + 127) / 128);
  if (big >= 2L * sms)
    return launch_tile<2, 4, 4, 4, 1>(a, sa, b, sb, o, M, N, K, gs, s);
  return launch_tile<2, 2, 2, 4, 4>(a, sa, b, sb, o, M, N, K, gs, s);
}
