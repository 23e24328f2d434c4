"""Llama-3.2-3B: dense GQA decoder [hf:meta-llama/Llama-3.2-3B].

28 layers, d_model 3072, 24 query heads over 8 KV heads of 128, d_ff 8192,
vocab 128256, rope theta 5e5; bfloat16 compute (the schema default), so
the KV pool holds bfloat16 rows unless ``kv_cache_dtype`` is ``"int8"``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama3.2-3b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab_size=128256, head_dim=128,
        rope_theta=5e5,
    )
