"""hubert-xlarge — audio encoder-only (w2v2 arch). [arXiv:2106.07447; unverified]

48L d_model=1280 16H d_ff=5120 vocab=504 (masked-prediction cluster units).
The CNN waveform frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (batch, frames, d_model).  Bidirectional
attention, layer norm and a two-layer GELU MLP; no decode step.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    encoder_only=True,
    input_kind="embeds",
    mlp_kind="gelu2",
    activation="gelu",
    norm_kind="layer",
    rope_theta=10000.0,  # conv-pos-embed replaced by rope (the reference's)
    skip_shapes=("decode_32k", "long_500k"),
    notes="encoder-only: no autoregressive decode",
))
