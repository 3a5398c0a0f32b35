"""deepseek-7b — dense llama-arch MHA. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10000.0,
    skip_shapes=("long_500k",),
    notes="full attention => long_500k skipped per assignment",
))
