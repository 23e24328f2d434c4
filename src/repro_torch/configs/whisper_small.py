"""Whisper-small: an encoder-decoder audio backbone [arXiv:2212.04356].

12 encoder and 12 decoder layers, d_model 768, 12 heads of 64 (MHA), d_ff
3072, vocab 51865 (head 51968 rows), LayerNorm and a GELU MLP (the tanh
form, as ``jax.nn.gelu``'s default), learned encoder and decoder
positions (no rope), the head tied with the embedding; f32 params and
bfloat16 compute (the schema defaults).  The conv frontend is a stub, as
in the JAX package: the encoder takes precomputed frame embeddings (B,
1504, D), 1500 frames padded to 1504.
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-small")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-small", family="audio",
        n_layers=12, n_enc_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab_size=51865, head_dim=64,
        rope_type="none", norm_type="layernorm", mlp_type="gelu",
        enc_seq=1504,
        train_shard="dp",
        frontend="audio_stub", tie_embeddings=True,
    )
