// Causal flash attention over a whole prompt (one-shot prefill), on the
// tensor cores in error-compensated TF32 (3xTF32).
//
// Replaces src/repro/kernels/flash_prefill.py::flash_prefill_pallas
// (pallas_call at flash_prefill.py:173).
//
//   q        (B, Sq, H, D) f32, unscaled: the kernel scales it by `scale`
//            (the caller's D^-1/2) in f32, as the TPU kernel does
//   k/v      (B, Sk, KVH, D) f32; query head h reads kv-head h / (H / KVH)
//            (GQA heads are indexed, never repeated in memory)
//   q_offset, q_lens, k_lens  (B,) int32 device data, or null for
//            (0, Sq, Sk): query i of row b sits at position q_offset[b] + i
//            and attends keys < k_lens[b] (and <= its position when causal)
//   out      (B, Sq, H, D) f32; queries at or past q_lens[b], and queries
//            with no live key, are exactly 0
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
// the f32 CUDA cores (67 TFLOP/s) would take 2.5x that floor.
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
//  * Order and occupancy.  blockIdx.y runs from the last query tile (most
//    key tiles, when causal) to the first, so the heaviest blocks start
//    first.  At D = 64 a block holds 105 KB of shared memory and its lanes
//    under 180 registers: one block (8 warps) an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_prefill_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ q_offset,
                         const int* __restrict__ q_lens,
                         const int* __restrict__ k_lens,
                         float* __restrict__ out, int Sq, int Sk, int H,
                         int KVH, int causal, float scale) {
  constexpr int LK = D + 8, LV = D + 4;   // padded row strides (floats)
  constexpr int KS = D / 8;               // k-steps of S, d-tiles of O
  constexpr int CH = D / 4;               // 16-byte chunks a row
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm;                         // [2][kTK][LK] raw, then big
  float* Vs = Ks + 2 * kTK * LK;          // [2][kTK][LV] raw, then big
  float* Kl = Vs + 2 * kTK * LV;          // [kTK][LK]    small
  float* Vl = Kl + kTK * LK;              // [kTK][LV]    small

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
      const float* qa = q + (((size_t)b * Sq + r0 + ra) * H + h) * D + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float2 xa = make_float2(0.f, 0.f), xb = xa;
        if (ra < nrows) xa = *reinterpret_cast<const float2*>(qa + 8 * kk);
        if (rb < nrows)
          xb = *reinterpret_cast<const float2*>(qa + 8 * rs + 8 * kk);
        split(xa.x * qscale, qb[kk][0], qs[kk][0]);
        split(xb.x * qscale, qb[kk][1], qs[kk][1]);
        split(xa.y * qscale, qb[kk][2], qs[kk][2]);
        split(xb.y * qscale, qb[kk][3], qs[kk][3]);
      }
    }

    const int ntiles = (kend + kTK - 1) / kTK;
    auto load = [&](int tile, int stage) {
      const int t0 = tile * kTK;
      float* kd = Ks + stage * kTK * LK;
      float* vd = Vs + stage * kTK * LV;
      for (int i = threadIdx.x; i < kTK * CH; i += kThreads) {
        const int r = i / CH, c = (i - r * CH) * 4;
        const bool in = t0 + r < kend;
        const size_t at =
            in ? (((size_t)b * Sk + t0 + r) * KVH + kvh) * D + c : 0;
        cp_async16(kd + r * LK + c, k + at, in);
        cp_async16(vd + r * LV + c, v + at, in);
      }
      asm volatile("cp.async.commit_group;");
    };

    load(0, 0);
    for (int it = 0; it < ntiles; ++it) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();  // tile it is in; every warp is done with it - 1
      if (it + 1 < ntiles) load(it + 1, (it + 1) & 1);
      float* kt = Ks + (it & 1) * kTK * LK;
      float* vt = Vs + (it & 1) * kTK * LV;
      split_tile<D>(kt, vt, Kl, Vl);  // big in place, small beside it
      __syncthreads();
      const int k0 = kh * (kTK / kKH);  // this warp's keys in the tile
      const int t0 = it * kTK + k0;
      if (t0 >= wend) continue;  // warp-uniform: nothing this warp needs

      warp_tile<D>(kt, Kl, vt, Vl, k0, t0, lim_a, lim_b, qb, qs, mrow,
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

template <int D>
int launch(const void* q, const void* k, const void* v, const void* off,
           const void* qlens, const void* klens, void* out, int B, int Sq,
           int Sk, int H, int KVH, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = 3 * kTK * ((D + 8) + (D + 4)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (Sq + kR - 1) / kR);
  flash_prefill_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(off),
      static_cast<const int*>(qlens), static_cast<const int*>(klens),
      static_cast<float*>(out), Sq, Sk, H, KVH, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors contiguous and q/k/v 16-byte aligned; D in {32, 64, 128} and
// H % KVH == 0 (the wrapper checks); q_offset/q_lens/k_lens may each be
// null.  Returns a cudaError_t (0 = launched).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* q_offset, const void* q_lens,
                             const void* k_lens, void* out, int B, int Sq,
                             int Sk, int H, int KVH, int D, int causal,
                             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, q_offset, q_lens, k_lens, out, B, Sq, Sk, H,
                        KVH, causal, scale, st);
    case 64:
      return launch<64>(q, k, v, q_offset, q_lens, k_lens, out, B, Sq, Sk, H,
                        KVH, causal, scale, st);
    case 128:
      return launch<128>(q, k, v, q_offset, q_lens, k_lens, out, B, Sq, Sk,
                         H, KVH, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
