"""granite-moe-3b-a800m — MoE, 40 experts top-8, per-expert d_ff=512.
[hf:ibm-granite granite-3.0-3b-a800m; hf]

The reference's exact fields (``repro/configs/granite_moe_3b.py``): like
the reference, the config mirrors the repo's ``ArchConfig`` and leaves out
the HF card's embedding, attention, residual and logits multipliers.  On
one device the expert count stays 40 (``ShardPlan.e_pad``); the reference
pads it to a multiple of its model-parallel degree.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    expert_d_ff=512,
    rope_theta=10000.0,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
    notes="full attention => long_500k skipped per assignment",
))
