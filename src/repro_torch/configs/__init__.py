"""Config registry: one module per ported architecture."""
from repro_torch.configs.base import ArchConfig, get_config, list_archs, register

# import every arch module so registration happens on package import
from repro_torch.configs import llama2_7b  # noqa: F401

__all__ = ["ArchConfig", "get_config", "list_archs", "register"]
