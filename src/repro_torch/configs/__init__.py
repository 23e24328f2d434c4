"""Architecture configs of the port: llama2-110m, llama3.2-3b,
phi4-mini-3.8b and glm4-9b."""
from repro_torch.configs.base import ModelConfig, get_config, reduced

__all__ = ["ModelConfig", "get_config", "reduced"]
