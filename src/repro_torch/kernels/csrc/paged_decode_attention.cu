// One-token GQA attention read through a page table (paged flash-decode).
//
// Replaces src/repro/kernels/paged_decode_attention.py::
// paged_decode_attention_pallas (pallas_call at paged_decode_attention.py:138).
//
//   q          (B, KVH, HQ, D) f32, already scaled by 1/sqrt(D)
//   k/v pool   (NB, BS, KVH, D) f32 or bf16, or int8 with ks/vs (NB, BS,
//              KVH) f32
//   page_table (B, MB) int32, -1 = unassigned;  lens (B,) int32
//   out        (B, KVH, HQ, D) f32 = softmax(q k^T over positions < lens[b]) v
//
// Position t of row b is pool row (max(page_table[b, t / BS], 0), t % BS):
// a -1 entry inside a row's length reads pool block 0, as the reference
// and its Pallas kernel do, and only lens masks.  What bounds it, and the
// design (a split-K flash-decode merged over a thread-block cluster), are
// flash_decode.cuh's, shared with decode_attention.cu.
#include "flash_decode.cuh"

// All tensors contiguous, D % 4 == 0, the HQ heads of a KV head in NG
// groups of at most 1024 / D (the wrapper checks: ops.decode_head_groups).
// kind: the pool's element, 0 f32, 1 int8 (ks/vs are ignored otherwise),
// 2 bf16.  Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention(const void* q, const void* kpool,
                                      const void* vpool, const void* ks,
                                      const void* vs, const void* page_table,
                                      const void* lens, void* out, int B,
                                      int KVH, int HQ, int D, int BS, int MB,
                                      int kind, int NG, void* stream) {
  const flash_decode::PagedRows rows{static_cast<const int*>(page_table), MB,
                                     BS, KVH};
  return flash_decode::run(rows, q, kpool, vpool, ks, vs, lens, out, B, KVH,
                           HQ, NG, D, kind, static_cast<cudaStream_t>(stream));
}
