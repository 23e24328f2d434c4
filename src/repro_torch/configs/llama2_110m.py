"""Llama-2 110M (TinyStories): the paper's own evaluation model.

Karpathy llama2.c dims (paper Appendix A.1): 12 layers, d_model 768,
12 heads, 12 KV heads, 1024 context, 32000 vocab.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama2-110m")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama2-110m", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=2048, vocab_size=32000, head_dim=64,
        rope_theta=1e4, compute_dtype="float32",
    )
