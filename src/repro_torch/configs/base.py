"""Model configuration schema and the architecture registry.

The port's own copy of ``repro/configs/base.py`` (the port imports nothing
of the JAX package): the same fields and defaults, so one configuration
means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # positions / attention
    rope_theta: float = 1e4
    rope_type: str = "rope"     # rope | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    q_chunk: int = 512          # blockwise-attention query chunk

    # norm / activation
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    mlp_type: str = "swiglu"    # swiglu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_group: int = 512
    capacity_factor: float = 1.25
    moe_every: int = 1

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0

    # encoder-decoder (audio)
    n_enc_layers: int = 0
    enc_seq: int = 1500
    max_pos: int = 32_768
    frontend: str = "none"

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "block"
    tie_embeddings: bool = True
    eps: float = 1e-5

    # serving
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8
    subquadratic: bool = False
    serve_attn_shard: str = "din"

    # distribution strategy knobs
    moe_shard: str = "model"
    train_shard: str = "tp"

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def padded_vocab(self, multiple: int = 256) -> int:
        """Embedding / LM-head rows, padded to a multiple of ``multiple``."""
        return -(-self.vocab_size // multiple) * multiple

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


LM_SHAPES = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import the module of the same name to trigger registration
        import importlib
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    """Every registered architecture: each module of
    ``repro_torch.configs`` is imported, which registers its config."""
    import importlib
    import pkgutil
    import repro_torch.configs as pkg
    for mod in pkgutil.iter_modules(pkg.__path__):
        if mod.name not in ("base", "__init__"):
            importlib.import_module(f"repro_torch.configs.{mod.name}")
    return sorted(_REGISTRY)


def shapes_for(cfg: ModelConfig) -> list[ShapeCell]:
    """The assigned shape cells that apply to this architecture:
    ``long_500k`` only where sequence mixing is sub-quadratic (the SSM and
    hybrid families)."""
    return [c for c in LM_SHAPES
            if c.name != "long_500k" or cfg.subquadratic]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests and the CPU-vs-card check."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        q_chunk=64,
        ssm_chunk=32,
        moe_group=64,
    )
    if cfg.rope_type == "mrope":
        kw.update(mrope_sections=(4, 6, 6))
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.attn_every:
        kw.update(n_layers=5, attn_every=2)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2, enc_seq=64)
    return cfg.with_(**kw)
