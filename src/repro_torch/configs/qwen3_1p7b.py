"""qwen3-1.7b — dense GQA with qk_norm. [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
    notes="full attention => long_500k skipped per assignment",
))
