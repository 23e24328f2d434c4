"""Architecture configs of the port (llama2-110m in this slice)."""
from repro_torch.configs.base import ModelConfig, get_config, reduced

__all__ = ["ModelConfig", "get_config", "reduced"]
