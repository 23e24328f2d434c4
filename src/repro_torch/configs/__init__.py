"""Architecture configs of the port: llama2-110m and llama3.2-3b."""
from repro_torch.configs.base import ModelConfig, get_config, reduced

__all__ = ["ModelConfig", "get_config", "reduced"]
