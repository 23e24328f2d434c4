// Rotary position embedding, rotate-half, on one decode step's heads.
//
// Replaces src/repro/kernels/rope.py::rope_pallas (pallas_call at
// rope.py:48).
//
//   x        (B, H, D) f32: heads contiguous within a row, rows `x_stride`
//            floats apart -- so the q and k heads of a fused qkv row (the
//            first H of its heads) are rotated in one launch, read in place
//   cos/sin  (B, D) f32, one angle row per batch row, broadcast over heads
//   out      (B, H, D) f32 contiguous = x * cos + [-x2, x1] * sin
//
// What bounds it on an H100: bytes (and, at decode sizes, the launch): each
// element is read and written once with three multiplies and an add.
//
// Design: one block per batch row stages its angle row in shared memory,
// then its threads walk the row's H*D outputs, each reading its own element
// and its rotation partner.  Products and the sum are rounded separately
// (no fused multiply-add), so the result is bitwise the plain version's.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void rope_kernel(const float* __restrict__ x,
                            const float* __restrict__ cs,
                            const float* __restrict__ sn,
                            float* __restrict__ out, int H, int D,
                            int x_stride) {
  extern __shared__ float ang[];  // [2][D]: cos then sin
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    ang[i] = cs[(size_t)b * D + i];
    ang[D + i] = sn[(size_t)b * D + i];
  }
  __syncthreads();
  const int half = D / 2;
  const float* xb = x + (size_t)b * x_stride;
  float* ob = out + (size_t)b * H * D;
  for (int i = threadIdx.x; i < H * D; i += kThreads) {
    const int d = i % D;
    const float xv = xb[i];
    const float rot = d < half ? -xb[i + half] : xb[i - half];
    ob[i] = __fadd_rn(__fmul_rn(xv, ang[d]), __fmul_rn(rot, ang[D + d]));
  }
}

}  // namespace

// D even; x_stride >= H*D (the wrapper checks).  Returns a cudaError_t.
extern "C" int rope(const void* x, const void* cos, const void* sin,
                    void* out, int B, int H, int D, int x_stride,
                    void* stream) {
  rope_kernel<<<B, kThreads, 2 * D * sizeof(float),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<float*>(out), H, D,
      x_stride);
  return (int)cudaGetLastError();
}
