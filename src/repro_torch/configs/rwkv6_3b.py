"""rwkv6-3b (Finch) — attention-free, data-dependent decay. [arXiv:2404.05892; hf]

32L d_model=2560 d_ff=8960 vocab=65536; head_dim 64 => 40 wkv heads.
O(1) state per layer => runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attn_kind="none",
    rwkv=True,
    rwkv_lora_w=64,
    mlp_kind="rwkv_cmix",
    notes="attention-free; runs long_500k",
))
