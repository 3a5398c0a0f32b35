"""minicpm3-4b — dense, MLA latent attention. [hf:openbmb/MiniCPM3-4B; hf]

62L d_model=2560 40H d_ff=6400 vocab=73448.  MLA dims follow the HF config
(q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head=64); the
assignment's "GQA kv=40" denotes MHA-equivalent head count, realised here as
true MLA per the arch note.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=96,  # qk_nope + qk_rope
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    rope_theta=10000.0,
    skip_shapes=("long_500k",),
    notes="full attention (MLA) => long_500k skipped per assignment",
))
