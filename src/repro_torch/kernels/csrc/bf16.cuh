// bf16 rows widened to f32, for the kernels that read bf16 activations or
// KV pools (rope.cu, rmsnorm_quant.cu, flash_decode.cuh, tf32x3.cuh's
// split for flash_prefill.cu and paged_prefill_attention.cu).  A bf16
// value widens to f32 exactly.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// four consecutive bf16 values, loaded as 8 bytes, widened to f32
__device__ __forceinline__ float4 widen4(uint2 w) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
