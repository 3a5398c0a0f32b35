"""gemma-7b — dense, GeGLU, head_dim=256, tied embeddings. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="gelu",
    norm_plus_one=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    skip_shapes=("long_500k",),
    notes="full attention => long_500k skipped per assignment",
))
