"""GLM-4-9B: dense GQA decoder [hf:THUDM/glm-4-9b].

40 layers, d_model 4096, 32 query heads over 2 KV heads of 128 (16 query
heads a KV head: the decode attentions cut them into two groups of 8),
d_ff 13696, vocab 151552, rope theta 1e4; bfloat16 compute and KV pool
(the schema defaults), the head tied with the embedding.
"""
from repro_torch.configs.base import ModelConfig, register


@register("glm4-9b")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab_size=151552, head_dim=128,
        rope_theta=1e4,
    )
