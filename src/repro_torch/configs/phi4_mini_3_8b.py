"""Phi-4-mini (3.8B): dense GQA, RoPE + SwiGLU [arXiv:2412.08905].

llama3.2-3b's family and head layout (d_model 3072, 24 query heads over 8
KV heads of 128, d_ff 8192) at 32 layers, vocab 200064 and rope theta 1e4;
bfloat16 compute and KV pool (the schema defaults), the head tied with the
embedding.
"""
from repro_torch.configs.base import ModelConfig, register


@register("phi4-mini-3.8b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab_size=200064, head_dim=128,
        rope_theta=1e4,
    )
