"""Command-R 35B: dense GQA decoder, no biases
[hf:CohereForAI/c4ai-command-r-v01].

40 layers, d_model 8192, 64 query heads over 8 KV heads of 128, d_ff
22528, vocab 256000, rope theta 8e6; bfloat16 compute and KV pool (the
schema defaults), RMSNorm, SwiGLU and the head tied with the embedding, as
the JAX package's config has them (not the published model's LayerNorm,
parallel blocks and logit scale).  The 256000 x 8192 head holds 2.1e9
codes, 2.3% under 2^31.
"""
from repro_torch.configs.base import ModelConfig, register


@register("command-r-35b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22528, vocab_size=256000, head_dim=128,
        rope_theta=8e6,
    )
