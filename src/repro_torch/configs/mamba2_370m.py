"""Mamba2-370M: attention-free SSD [arXiv:2405.21060].

48 Mamba2 layers, d_model 1024 (d_inner 2048: 32 SSM heads of 64, one
B/C group, state 128, conv width 4), no attention and no rope, vocab 50280
(head 50432 rows), the head tied with the embedding; f32 params and bf16
compute (the schema defaults).  The in / out projections are quantized; the
SSM dynamics (``wdt``, the convolutions, ``A_log``, ``dt_bias``,
``D_skip``) stay f32.
"""
from repro_torch.configs.base import ModelConfig, register


@register("mamba2-370m")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        conv_width=4, rope_type="none", subquadratic=True,
    )
