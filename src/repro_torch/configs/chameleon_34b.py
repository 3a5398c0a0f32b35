"""chameleon-34b — early-fusion VLM; VQ image tokens live in the text vocab.
[arXiv:2405.09818; unverified]

The modality frontend (VQ-GAN tokenizer) is a stub: the backbone takes
interleaved text+image token ids directly, which is exactly what early
fusion means at the backbone level.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,  # chameleon qk-norm (rms variant here)
    rope_theta=10000.0,
    skip_shapes=("long_500k",),
    notes="full attention => long_500k skipped per assignment",
))
