"""Llama-4-Maverick 400B-A17B: the llama4 interleave, dense and MoE layers
in turn, 128 experts top 1 [hf:meta-llama/Llama-4-Maverick-17B-128E].

48 layers, d_model 5120, 40 query heads over 8 KV heads of 128, d_ff 8192
(the dense MLP and each expert), vocab 202048 (head 202240 rows), rope
theta 5e5; bfloat16 params, compute and KV cache.  ``moe_every`` 2: 24
patterns of one dense layer and one MoE layer (the router f32, the three
expert banks quantized; groups of ``moe_group`` 512 tokens at capacity
factor 1.25), ~400B parameters with ~17B active.  The text backbone only,
as in the JAX package.  Its Q8_0 tree is ~424 GB: one card serves it cut
in depth (``cfg.with_(n_layers=4)``, two patterns).
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama4-maverick-400b-a17b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202048, head_dim=128,
        n_experts=128, top_k=1, moe_every=2,
        rope_theta=5e5, param_dtype="bfloat16", moe_shard="ep_data",
    )
