"""Config registry: one module per ported architecture."""
from repro_torch.configs.base import ArchConfig, get_config, list_archs, register

# import every arch module so registration happens on package import
from repro_torch.configs import (chameleon_34b,  # noqa: F401
                                 deepseek_7b, gemma_7b, granite_moe_3b,
                                 hubert_xlarge, hymba_1p5b, llama2_7b,
                                 minicpm3_4b, qwen3_1p7b, qwen3_moe_235b,
                                 rwkv6_3b)
from repro_torch.configs.drafters import (DRAFT_PAIRS, check_draft_pair,
                                          drafter_for)
from repro_torch.configs.shapes import (SHAPES, Shape, input_specs,
                                        runnable_cells)

ASSIGNED = [
    "minicpm3-4b",
    "qwen3-1.7b",
    "deepseek-7b",
    "gemma-7b",
    "hymba-1.5b",
    "chameleon-34b",
    "granite-moe-3b-a800m",
    "qwen3-moe-235b-a22b",
    "rwkv6-3b",
    "hubert-xlarge",
]

__all__ = ["ASSIGNED", "ArchConfig", "DRAFT_PAIRS", "SHAPES", "Shape",
           "check_draft_pair", "drafter_for", "get_config", "input_specs",
           "list_archs", "register", "runnable_cells"]
