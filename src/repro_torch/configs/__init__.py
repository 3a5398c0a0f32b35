"""Config registry: one module per ported architecture."""
from repro_torch.configs.base import ArchConfig, get_config, list_archs, register

# import every arch module so registration happens on package import
from repro_torch.configs import (granite_moe_3b,  # noqa: F401
                                 hubert_xlarge, hymba_1p5b, llama2_7b,
                                 rwkv6_3b)
from repro_torch.configs.drafters import (DRAFT_PAIRS, check_draft_pair,
                                          drafter_for)

__all__ = ["ArchConfig", "DRAFT_PAIRS", "check_draft_pair", "drafter_for",
           "get_config", "list_archs", "register"]
