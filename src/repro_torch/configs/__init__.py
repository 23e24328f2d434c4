"""Architecture configs of the port: llama2-110m, llama3.2-3b,
phi4-mini-3.8b, glm4-9b and command-r-35b (every dense config of the JAX
package), qwen3-moe-30b-a3b (its MoE config without an interleave), the SSM
families, mamba2-370m (ssm) and zamba2-1.2b (hybrid), qwen2-vl-7b (vlm,
M-RoPE) and whisper-small (audio, encoder-decoder)."""
from repro_torch.configs.base import (LM_SHAPES, ModelConfig, ShapeCell,
                                      get_config, list_configs, reduced,
                                      shapes_for)

__all__ = ["LM_SHAPES", "ModelConfig", "ShapeCell", "get_config",
           "list_configs", "reduced", "shapes_for"]
