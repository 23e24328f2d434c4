// One-token GQA attention against a dense per-slot KV cache (flash-decode).
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention_pallas
// (pallas_call at decode_attention.py:206).
//
//   q      (B, KVH, HQ, D) f32, already scaled by 1/sqrt(D)
//   k/v    (B, S, KVH, D) f32 or bf16, or int8 with ks/vs (B, S, KVH) f32
//   lens   (B,) int32: row b attends positions < min(lens[b], S)
//   out    (B, KVH, HQ, D) f32 = softmax(q k^T over live positions) v
//
// Position t of row b is cache row (b, t).  What bounds it, and the design
// (a split-K flash-decode merged over a thread-block cluster), are
// flash_decode.cuh's, shared with paged_decode_attention.cu: the same
// positions folded in the same order with the same arithmetic, so the two
// kernels are bitwise equal on the same rows.
#include "flash_decode.cuh"

// All tensors contiguous, D % 4 == 0, the HQ heads of a KV head in NG
// groups of at most 1024 / D (the wrapper checks: ops.decode_head_groups).
// kind: the cache's element, 0 f32, 1 int8 (ks/vs are ignored otherwise),
// 2 bf16.  Returns a cudaError_t (0 = launched).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* lens, void* out, int B, int S,
                                int KVH, int HQ, int D, int kind, int NG,
                                void* stream) {
  const flash_decode::DenseRows rows{S, KVH};
  return flash_decode::run(rows, q, k, v, ks, vs, lens, out, B, KVH, HQ, NG,
                           D, kind, static_cast<cudaStream_t>(stream));
}
