"""Qwen3-30B-A3B: MoE decoder, 128 experts top 8 [hf:Qwen/Qwen3-30B-A3B].

48 layers, d_model 2048, 32 query heads over 4 KV heads of 64 (the JAX
package's head_dim, not the published model's 128; no QK-norm, as the JAX
package has none), 128 experts of d_ff 768 each, top 8, vocab 151936 (head
152064 rows), rope theta 1e6; bfloat16 params, compute and KV pool.  Every
layer is MoE (``moe_every`` 1): the router stays f32 and the three expert
banks are quantized; groups of ``moe_group`` 512 tokens at capacity factor
1.25 (the schema defaults).
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-moe-30b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=768, vocab_size=151936, head_dim=64,
        n_experts=128, top_k=8,
        rope_theta=1e6, param_dtype="bfloat16",
        moe_shard="ep_data",
    )
