"""hymba-1.5b — hybrid: parallel SWA-attention + mamba heads per layer.
[arXiv:2411.13676; hf]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Deviation (the reference's): the published Hymba keeps 3 layers on full
attention and uses meta-tokens; here every layer uses SWA (window 1024),
so the stack is uniform and sub-quadratic, and meta-tokens are omitted.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_kind="swa",
    window=1024,
    ssm_state=16,
    ssm_expand=2,
    conv_width=4,
    rope_theta=10000.0,
    notes="runs long_500k (SWA + SSM are sub-quadratic)",
))
