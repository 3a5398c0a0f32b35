"""llama2-7b — the paper's own SaaS model (TAPAS profiles Llama2 7B/13B/70B)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    rope_theta=10000.0,
    skip_shapes=("long_500k",),
    notes="paper's SaaS workload model",
))

CONFIG_13B = register(ArchConfig(
    name="llama2-13b",
    family="dense",
    num_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=13824,
    vocab_size=32000,
    rope_theta=10000.0,
    skip_shapes=("long_500k",),
    notes="paper's SaaS workload model (mid size)",
))

CONFIG_70B = register(ArchConfig(
    name="llama2-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32000,
    rope_theta=10000.0,
    skip_shapes=("long_500k",),
    notes="paper's SaaS workload model (large size)",
))
