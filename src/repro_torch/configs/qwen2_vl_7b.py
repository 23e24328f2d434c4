"""Qwen2-VL-7B: the language backbone of a VLM with M-RoPE
[arXiv:2409.12191].

28 layers, d_model 3584, 28 query heads over 4 KV heads of 128 (7 query
heads a KV head), d_ff 18944, vocab 152064, rope theta 1e6; multimodal
rotary positions (``rope_type`` mrope: the rotation pairs of a head cut
16 / 24 / 24 between the temporal, height and width position streams);
f32 params, bfloat16 compute and KV pool (the schema defaults), the head
tied with the embedding.  The vision frontend is a stub, as in the JAX
package: ``Model.prefill`` takes precomputed patch embeddings (B, S, D)
and (3, B, S) positions; text tokens take all three streams equal.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-7b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064, head_dim=128,
        rope_theta=1e6, rope_type="mrope", mrope_sections=(16, 24, 24),
        frontend="vision_stub",
    )
