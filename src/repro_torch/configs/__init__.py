"""Config registry: one module per ported architecture."""
from repro_torch.configs.base import ArchConfig, get_config, list_archs, register

# import every arch module so registration happens on package import
from repro_torch.configs import (chameleon_34b,  # noqa: F401
                                 deepseek_7b, gemma_7b, granite_moe_3b,
                                 hubert_xlarge, hymba_1p5b, llama2_7b,
                                 qwen3_1p7b, qwen3_moe_235b, rwkv6_3b)
from repro_torch.configs.drafters import (DRAFT_PAIRS, check_draft_pair,
                                          drafter_for)

__all__ = ["ArchConfig", "DRAFT_PAIRS", "check_draft_pair", "drafter_for",
           "get_config", "list_archs", "register"]
