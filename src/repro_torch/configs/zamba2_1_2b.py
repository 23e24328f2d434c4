"""Zamba2-1.2B: a Mamba2 backbone with one shared attention block
[arXiv:2411.15242].

38 Mamba2 layers, d_model 2048 (d_inner 4096: 64 SSM heads of 64, one
B/C group, state 64, conv width 4); ONE attention + SwiGLU block (32 query
heads over 32 KV heads of 64, rope theta 1e4, d_ff 8192), its weights
shared by its six applications, one after every 6th SSM layer (the last 2
SSM layers have none after them); vocab 32000; f32 params and bf16
compute (the schema defaults).
"""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-1.2b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000, head_dim=64,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        conv_width=4, attn_every=6, rope_theta=1e4, subquadratic=True,
    )
