// Rotary position embedding, rotate-half, on one decode step's heads.
//
// Replaces src/repro/kernels/rope.py::rope_pallas (pallas_call at
// rope.py:48).
//
//   x        (B, H, D) f32 or bf16: heads contiguous within a row, rows
//            `x_stride` elements apart -- so the q and k heads of a fused
//            qkv row (the first H of its heads) are rotated in one launch,
//            read in place
//   cos/sin  (B, D) f32, one angle row per batch row, broadcast over heads
//   out      (B, H, D) of x's type, contiguous = x * cos + [-x2, x1] * sin,
//            computed in f32 and rounded once to x's type
//
// What bounds it on an H100: bytes -- each element is read and written once
// with three multiplies and an add -- and at decode sizes (B <= 8, 24 heads
// of 64, or llama3.2-3b's 32 q and k heads of 128) the launch and one trip
// to memory, which is all the call is.
//
// Design (a latency kernel): one thread owns a 4-wide slice d..d+3 of one
// head's first half and the matching slice d + D/2.. of its second half:
// 4-wide loads of x1, x2 (16 bytes of f32, 8 of bf16) and float4 loads of
// cos and sin at both places, two 4-wide stores, no shared memory and no
// barrier.  The grid spans (row, head, slice), 128 threads a block: at B =
// 8, 24 heads of 64 that is 1536 threads in 12 blocks.  Where D is not a
// multiple of 8, or x, its row stride, cos, sin or out do not allow those
// accesses, the same mapping runs one column a thread (the scalar path).
// Products and the sum are rounded separately (no fused multiply-add), and
// a bf16 result is rounded to nearest even from that f32 sum, so the
// result is bitwise the plain version's.  PDL (pdl.cuh): only cos and sin
// (computed before the step's first layer) may be read before
// griddepcontrol.wait; x is read after it (through L2, coherent), and out
// written after it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"
#include "pdl.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float rot_lo(float x1, float x2, float c,
                                        float s) {
  return __fadd_rn(__fmul_rn(x1, c), __fmul_rn(-x2, s));
}

__device__ __forceinline__ float rot_hi(float x1, float x2, float c,
                                        float s) {
  return __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

template <class T>
__device__ __forceinline__ void store(T* p, float v) {
  if constexpr (std::is_same<T, float>::value) *p = v;
  else *p = __float2bfloat16_rn(v);
}

template <class T>
__device__ __forceinline__ void store(T* p, float4 v) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&a);
    w.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = w;
  }
}

// kW columns a thread (4: 4-wide accesses; 1: the scalar path); T: the
// element of x and out (float or __nv_bfloat16)
template <int kW, class T>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* x, const float* __restrict__ cs,
            const float* __restrict__ sn, T* __restrict__ out, int B, int H,
            int D, int x_stride) {
  using V = typename std::conditional<kW == 4, float4, float>::type;
  const int half = D / 2;
  const int slices = half / kW;                         // a head
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * H * slices) return;
  const int d = (idx % slices) * kW;
  const int bh = idx / slices;
  const int h = bh % H, b = bh / H;
  const V* ca = reinterpret_cast<const V*>(cs + (size_t)b * D + d);
  const V* sa = reinterpret_cast<const V*>(sn + (size_t)b * D + d);
  const V c1 = __ldg(ca), c2 = __ldg(ca + half / kW);
  const V s1 = __ldg(sa), s2 = __ldg(sa + half / kW);
  grid_dependency_wait();

  const T* xr = x + (size_t)b * x_stride + (size_t)h * D + d;
  T* orow = out + ((size_t)b * H + h) * D + d;
  V x1, x2;                              // through L2: coherent
  if constexpr (std::is_same<T, float>::value) {
    x1 = __ldcg(reinterpret_cast<const V*>(xr));
    x2 = __ldcg(reinterpret_cast<const V*>(xr + half));
  } else if constexpr (kW == 4) {
    x1 = widen4(__ldcg(reinterpret_cast<const uint2*>(xr)));
    x2 = widen4(__ldcg(reinterpret_cast<const uint2*>(xr + half)));
  } else {
    x1 = __bfloat162float(__ldcg(xr));
    x2 = __bfloat162float(__ldcg(xr + half));
  }
  V o1, o2;
  if constexpr (kW == 4) {
    o1 = make_float4(rot_lo(x1.x, x2.x, c1.x, s1.x),
                     rot_lo(x1.y, x2.y, c1.y, s1.y),
                     rot_lo(x1.z, x2.z, c1.z, s1.z),
                     rot_lo(x1.w, x2.w, c1.w, s1.w));
    o2 = make_float4(rot_hi(x1.x, x2.x, c2.x, s2.x),
                     rot_hi(x1.y, x2.y, c2.y, s2.y),
                     rot_hi(x1.z, x2.z, c2.z, s2.z),
                     rot_hi(x1.w, x2.w, c2.w, s2.w));
  } else {
    o1 = rot_lo(x1, x2, c1, s1);
    o2 = rot_hi(x1, x2, c2, s2);
  }
  store(orow, o1);
  store(orow + half, o2);
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <class T>
int launch(const void* x, const void* cos, const void* sin, void* out, int B,
           int H, int D, int x_stride, cudaStream_t s) {
  const int w = 4 * (int)sizeof(T);  // bytes of a 4-wide access of x, out
  const bool vec = D % 8 == 0 && x_stride % 4 == 0 && aligned(x, w) &&
                   aligned(cos, 16) && aligned(sin, 16) && aligned(out, w);
  const int threads = B * H * (D / 2) / (vec ? 4 : 1);
  const dim3 grid((threads + kThreads - 1) / kThreads), block(kThreads);
  const T* xt = static_cast<const T*>(x);
  const float* cf = static_cast<const float*>(cos);
  const float* sf = static_cast<const float*>(sin);
  T* ot = static_cast<T*>(out);
  return vec ? (int)launch_pdl(rope_kernel<4, T>, grid, block, s, xt, cf, sf,
                               ot, B, H, D, x_stride)
             : (int)launch_pdl(rope_kernel<1, T>, grid, block, s, xt, cf, sf,
                               ot, B, H, D, x_stride);
}

}  // namespace

// D even; x_stride >= H*D, in elements (the wrapper checks); bf16 != 0: x
// and out hold bf16, else f32.  Returns a cudaError_t.
extern "C" int rope(const void* x, const void* cos, const void* sin,
                    void* out, int B, int H, int D, int x_stride, int bf16,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, cos, sin, out, B, H, D, x_stride, s)
              : launch<float>(x, cos, sin, out, B, H, D, x_stride, s);
}
