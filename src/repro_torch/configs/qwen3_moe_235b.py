"""qwen3-moe-235b-a22b — MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B family; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    expert_d_ff=1536,
    qk_norm=True,
    router_renorm=True,
    rope_theta=1_000_000.0,
    skip_shapes=("long_500k",),
    notes="full attention => long_500k skipped per assignment",
))
