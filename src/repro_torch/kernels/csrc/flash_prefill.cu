// Causal flash attention over a whole prompt (one-shot prefill), on the
// tensor cores in error-compensated TF32 (3xTF32).
//
// Replaces src/repro/kernels/flash_prefill.py::flash_prefill_pallas
// (pallas_call at flash_prefill.py:173).
//
//   q        (B, Sq, H, D) f32 or bf16: the kernel scales it by `scale` in
//            f32 (the caller's D^-1/2 for an unscaled f32 q, as the TPU
//            kernel does; 1 for a bf16 q the caller pre-scaled in bf16, as
//            the reference model does)
//   k/v      (B, Sk, KVH, D) of q's element; query head h reads kv-head
//            h / (H / KVH) (GQA heads are indexed, never repeated in
//            memory)
//   q_offset, q_lens, k_lens  (B,) int32 device data, or null for
//            (0, Sq, Sk): query i of row b sits at position q_offset[b] + i
//            and attends keys < k_lens[b] (and <= its position when causal)
//   out      (B, Sq, H, D) f32; queries at or past q_lens[b], and queries
//            with no live key, are exactly 0.  P stays f32 (normalized at
//            the end, as any flash kernel must): the reference rounds the
//            normalized P to bf16 before P.V, which an online softmax
//            cannot reproduce, so a bf16 caller's output parts from the
//            reference's by that one rounding (the tests state it)
//   D in {32, 64, 128}; q, k, v 16-byte aligned (the wrapper checks)
//
// What bounds it on an H100: operations.  Every K/V tile is used by the 64
// query rows of a block, so the two products (4 * pairs * D flops a head)
// outweigh the bytes.  They run on the tensor cores as three TF32 products
// each: x = big + small with big = tf32(x), small = tf32(x - big), and
// a.b ~ big.small + small.big + big.big (small.small dropped), which keeps
// about f32's accuracy where one TF32 product keeps ~3 decimal digits.  The
// floor is 3x the f32 flops at the dense TF32 rate (495 TFLOP/s, H100 SXM
// data sheet, a rate that only wgmma reaches; this kernel uses mma.sync);
// the f32 CUDA cores (67 TFLOP/s) would take 2.5x that floor.  On bf16
// q/k/v the function's floor is its flops at the dense bf16 rate (989
// TFLOP/s), 6x below what this kernel's two TF32 products a product (K and
// V exact, see bf16 below) can reach: it keeps f32's accuracy, not bf16's
// speed.
//
// Design, and what each part does about that bound (the arithmetic, warp
// tiling, permuted k index, split and merge live in tf32x3.cuh, shared
// with paged_prefill_attention.cu; its comment says what each does):
//  * Warp tiling.  One block of 8 warps per (b, query head, 64 query rows):
//    each 16-row group has two warps, one for each 32-key half of every
//    tile.  Two warps a row group halve the serial chain of the heaviest
//    block and put two warps on each scheduler, which hides the MMA and
//    load latencies.
//  * The split.  Q is scaled by D^-1/2 * log2(e) in f32 (scores in base 2,
//    so the softmax runs on exp2f) and split once per block into registers
//    (2 x D/2 words a lane).  Each K/V tile is split once, by the whole
//    block, right after it lands: big in place, small in a buffer beside
//    it.  P is split once per tile in registers.  TF32 rounding (cvt.rna)
//    is an integer add and mask.
//  * Loads.  64-key tiles of K and V arrive in shared memory by 16-byte
//    cp.async.cg, two stages: tile t + 1 loads while tile t is split and
//    computed, two barriers a tile.  Keys past the block's extent are
//    zero-filled by the src-size operand.
//  * Extents.  A block walks only the key tiles some live row needs (up to
//    min(k_len, q_offset + last live row + 1) when causal): tiles past a
//    row's extent or wholly above the diagonal are neither read nor
//    computed; a warp skips a key half none of its rows needs.  Masked keys
//    get probability exactly 0.
//  * bf16.  K/V rows are copied as they are stored (D bf16 values a row)
//    into a staging ring of two tiles, then widened to f32 exactly into
//    one f32 stage (tf32x3.cuh's widen_tile_bf16, as
//    paged_prefill_attention.cu does).  A widened bf16 value is exact in
//    TF32, so K and V have no small part: each product runs two MMAs
//    (small.big, big.big) instead of three, a third less tensor work with
//    the same bits as the three (the dropped one adds exact zeros), and
//    the tolerance is the f32 path's.  Q is widened as it is loaded and
//    split as f32 (its scaled value is not exact).  Half the bytes of the
//    f32 path cross from device memory.
//  * Order and occupancy.  blockIdx.y runs from the last query tile (most
//    key tiles, when causal) to the first, so the heaviest blocks start
//    first.  At D = 64 a block holds 105 KB of shared memory (bf16 67 KB)
//    and its lanes under 180 registers; at D = 128 201 KB (f32) or 131 KB
//    (bf16): one block (8 warps) an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

// two consecutive q values of element T, widened to f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// T: the element of q, k and v (float, or __nv_bfloat16 staged and split)
template <int D, class T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ q_offset,
                         const int* __restrict__ q_lens,
                         const int* __restrict__ k_lens,
                         float* __restrict__ out, int Sq, int Sk, int H,
                         int KVH, int causal, float scale) {
  constexpr bool RAW = !std::is_same<T, float>::value;  // staged, then split
  constexpr int LK = D + 8, LV = D + 4;   // padded row strides (floats)
  constexpr int KS = D / 8;               // k-steps of S, d-tiles of O
  constexpr int PB = D * (int)sizeof(T);  // bytes of a K/V row
  constexpr int CH = PB / 16;             // 16-byte chunks a row
  constexpr int NS = RAW ? 1 : 2;         // stages of the f32 tiles
  constexpr int NL = RAW ? 0 : 1;         // small-part tiles (bf16: none)
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;                         // [NS][kTK][LK] f32 (raw), big
  float* Vs = Ks + NS * kTK * LK;         // [NS][kTK][LV]
  float* Kl = Vs + NS * kTK * LV;         // [NL][kTK][LK] small
  float* Vl = Kl + NL * kTK * LK;         // [NL][kTK][LV] small
  // bf16: the rows [2][kTK][PB bytes] as they land
  unsigned char* Kc = reinterpret_cast<unsigned char*>(Vl + NL * kTK * LV);
  unsigned char* Vc = Kc + 2 * kTK * PB;

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int kvh = h / (H / KVH);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kR;  // heaviest first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % (kR / 16), kh = warp / (kR / 16);  // rows, keys
  const int g = lane >> 2, t = lane & 3;
  const int off = q_offset ? q_offset[b] : 0;
  const int qlen = min(q_lens ? q_lens[b] : Sq, Sq);
  const int klen = max(min(k_lens ? k_lens[b] : Sk, Sk), 0);
  const int nrows = min(qlen - r0, kR);   // live query rows of this block
  int kend = klen;                        // keys any live row needs
  if (causal) kend = min(kend, off + r0 + nrows);

  // this lane's two rows (of the block) and the keys each attends: < lim
  const int ra = 16 * rg + g, rb = ra + 8;
  const int lim_a = ra < nrows ? (causal ? min(klen, off + r0 + ra + 1)
                                         : klen) : 0;
  const int lim_b = rb < nrows ? (causal ? min(klen, off + r0 + rb + 1)
                                         : klen) : 0;
  // keys any live row of this warp needs
  const int wrows = min(nrows - 16 * rg, 16);
  int wend = wrows > 0 ? klen : 0;
  if (causal && wrows > 0) wend = min(wend, off + r0 + 16 * rg + wrows);

  float o[KS][4], mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  if (nrows > 0 && kend > 0) {
    // Q's A fragments, scaled and split once: a0/a1 (rows g, g + 8) at
    // column t = d 2t, a2/a3 at column t + 4 = d 2t + 1.  The scale folds
    // in log2(e), so scores are in base 2 and the softmax runs on exp2f.
    uint32_t qb[KS][4], qs[KS][4];
    {
      const float qscale = scale * kLog2e;
      const size_t rs = (size_t)H * D;
      const T* qa = q + (((size_t)b * Sq + r0 + ra) * H + h) * D + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float2 xa = make_float2(0.f, 0.f), xb = xa;
        if (ra < nrows) xa = load2(qa + 8 * kk);
        if (rb < nrows) xb = load2(qa + 8 * rs + 8 * kk);
        split(xa.x * qscale, qb[kk][0], qs[kk][0]);
        split(xb.x * qscale, qb[kk][1], qs[kk][1]);
        split(xa.y * qscale, qb[kk][2], qs[kk][2]);
        split(xb.y * qscale, qb[kk][3], qs[kk][3]);
      }
    }

    const int ntiles = (kend + kTK - 1) / kTK;
    // tile `tile` into stage `stage`: f32 rows into the f32 tiles, bf16
    // rows as they are into the staging ring
    auto load = [&](int tile, int stage) {
      const int t0 = tile * kTK;
      for (int i = threadIdx.x; i < kTK * CH; i += kThreads) {
        const int r = i / CH, c = i - r * CH;
        const bool in = t0 + r < kend;
        const size_t row = in ? ((size_t)b * Sk + t0 + r) * KVH + kvh : 0;
        const unsigned char* ks =
            reinterpret_cast<const unsigned char*>(k) + row * PB + 16 * c;
        const unsigned char* vs =
            reinterpret_cast<const unsigned char*>(v) + row * PB + 16 * c;
        if (RAW) {
          const int at = (stage * kTK + r) * PB + 16 * c;
          cp_async16(Kc + at, ks, in);
          cp_async16(Vc + at, vs, in);
        } else {
          cp_async16(Ks + (stage * kTK + r) * LK + 4 * c, ks, in);
          cp_async16(Vs + (stage * kTK + r) * LV + 4 * c, vs, in);
        }
      }
      asm volatile("cp.async.commit_group;");
    };

    load(0, 0);
    for (int it = 0; it < ntiles; ++it) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();  // tile it is in; every warp is done with it - 1
      if (it + 1 < ntiles) load(it + 1, (it + 1) & 1);
      const int st = RAW ? 0 : it & 1;
      float* kt = Ks + st * kTK * LK;
      float* vt = Vs + st * kTK * LV;
      if constexpr (RAW)  // exact in TF32: no small parts
        widen_tile_bf16<D>(
            reinterpret_cast<const __nv_bfloat16*>(Kc + (it & 1) * kTK * PB),
            reinterpret_cast<const __nv_bfloat16*>(Vc + (it & 1) * kTK * PB),
            kt, vt);
      else
        split_tile<D>(kt, vt, Kl, Vl);  // big in place, small beside it
      __syncthreads();
      const int k0 = kh * (kTK / kKH);  // this warp's keys in the tile
      const int t0 = it * kTK + k0;
      if (t0 >= wend) continue;  // warp-uniform: nothing this warp needs

      warp_tile<D, RAW>(kt, Kl, vt, Vl, k0, t0, lim_a, lim_b, qb, qs, mrow,
                        lrow, o);
    }
  }

  // merge the key parts into the kh = 0 warps, which write the rows
  if (!merge_key_parts<D>(sm, mrow, lrow, o)) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rb : ra;
    if (r0 + row >= Sq) continue;
    const float l = lrow[r];
    const float den = l > 0.f ? l : 1.f;
    float* ob = out + (((size_t)b * Sq + r0 + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < KS; ++n)
      *reinterpret_cast<float2*>(ob + 8 * n) =
          l > 0.f ? make_float2(o[n][2 * r] / den, o[n][2 * r + 1] / den)
                  : make_float2(0.f, 0.f);
  }
}

template <int D, class T>
int launch(const void* q, const void* k, const void* v, const void* off,
           const void* qlens, const void* klens, void* out, int B, int Sq,
           int Sk, int H, int KVH, int causal, float scale,
           cudaStream_t stream) {
  constexpr bool RAW = !std::is_same<T, float>::value;
  const int tiles = RAW ? 1 : 3;  // f32 tiles: bf16 one big; f32 2 + small
  size_t smem = tiles * kTK * ((D + 8) + (D + 4)) * sizeof(float);
  if (RAW) smem += 4 * kTK * D * sizeof(T);   // two stages of K and V rows
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (Sq + kR - 1) / kR);
  flash_prefill_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(off),
      static_cast<const int*>(qlens), static_cast<const int*>(klens),
      static_cast<float*>(out), Sq, Sk, H, KVH, causal, scale);
  return (int)cudaGetLastError();
}

// kind: the element of q, k and v, 0 f32, 2 bf16 (POOL_KINDS' numbers)
template <int D>
int launch_d(int kind, const void* q, const void* k, const void* v,
             const void* off, const void* qlens, const void* klens,
             void* out, int B, int Sq, int Sk, int H, int KVH, int causal,
             float scale, cudaStream_t stream) {
  switch (kind) {
    case 0:
      return launch<D, float>(q, k, v, off, qlens, klens, out, B, Sq, Sk, H,
                              KVH, causal, scale, stream);
    case 2:
      return launch<D, __nv_bfloat16>(q, k, v, off, qlens, klens, out, B,
                                      Sq, Sk, H, KVH, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous and q/k/v 16-byte aligned; D in {32, 64, 128} and
// H % KVH == 0 (the wrapper checks); q_offset/q_lens/k_lens may each be
// null; kind 0 f32, 2 bf16 (q, k and v alike).  Returns a cudaError_t (0 =
// launched).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* q_offset, const void* q_lens,
                             const void* k_lens, void* out, int B, int Sq,
                             int Sk, int H, int KVH, int D, int causal,
                             float scale, int kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(kind, q, k, v, q_offset, q_lens, k_lens, out, B,
                          Sq, Sk, H, KVH, causal, scale, st);
    case 64:
      return launch_d<64>(kind, q, k, v, q_offset, q_lens, k_lens, out, B,
                          Sq, Sk, H, KVH, causal, scale, st);
    case 128:
      return launch_d<128>(kind, q, k, v, q_offset, q_lens, k_lens, out, B,
                           Sq, Sk, H, KVH, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
