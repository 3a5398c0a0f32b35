"""Architecture config schema + registry (port of ``repro.configs.base``).

Every ported architecture gets one module in this package defining a
``CONFIG = ArchConfig(...)`` with the exact published hyper-parameters; the
registry maps the public ``--arch <id>`` names (dashes) to configs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encoder | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    attn_kind: str = "gqa"  # gqa | mla | swa | none (attn-free)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    window: int = 0  # sliding-window size when attn_kind == "swa"

    # MLA (DeepSeek/MiniCPM3-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    router_renorm: bool = True
    capacity_factor: float = 1.25

    # SSM / hybrid (mamba branch)
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_width: int = 4

    # rwkv6
    rwkv: bool = False
    rwkv_lora_w: int = 64

    # block flavour
    activation: str = "silu"
    mlp_kind: str = "glu"  # glu | gelu2 | rwkv_cmix
    norm_kind: str = "rms"  # rms | layer
    norm_plus_one: bool = False
    embed_scale: bool = False
    tie_embeddings: bool = False
    encoder_only: bool = False
    input_kind: str = "tokens"  # tokens | embeds

    skip_shapes: tuple = ()
    notes: str = ""

    # ------------------------------------------------------------------
    # derived quantities
    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """Mamba branch inner width."""
        return self.ssm_expand * self.d_model

    def attn_params_per_layer(self) -> int:
        d = self.d_model
        if self.attn_kind == "none":
            h = self.n_heads * self.head_dim
            lora = self.rwkv_lora_w
            return 5 * d * h + (d * lora + lora * h) + 5 * (d * 32 + 32 * d)
        if self.attn_kind == "mla":
            qk_dim = self.qk_nope_head_dim + self.qk_rope_head_dim
            p = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk_dim
            p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            p += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            p += self.n_heads * self.v_head_dim * d
            return p
        q = d * self.n_heads * self.head_dim
        kv = 2 * d * self.n_kv_heads * self.head_dim
        o = self.n_heads * self.head_dim * d
        p = q + kv + o
        if self.family == "hybrid":
            di = self.d_inner
            p += d * 2 * di
            p += di * self.conv_width
            p += di * (2 * self.ssm_state + 1)
            p += di * d
        return p

    def mlp_params_per_layer(self, active: bool = False) -> int:
        d = self.d_model
        if self.n_experts:
            e = self.top_k if active else self.n_experts
            router = d * self.n_experts
            return router + e * 3 * d * self.expert_d_ff
        if self.mlp_kind == "gelu2":
            return 2 * d * self.d_ff
        if self.mlp_kind == "rwkv_cmix":
            return 2 * d * self.d_ff + d * d
        return 3 * d * self.d_ff

    def param_count(self, active: bool = False) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        embed = self.vocab_size * self.d_model
        unembed = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        if self.input_kind == "embeds":
            embed = 0
        per_layer = self.attn_params_per_layer() + self.mlp_params_per_layer(active)
        norms = self.num_layers * 2 * self.d_model + self.d_model
        return embed + unembed + self.num_layers * per_layer + norms

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke_config(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            num_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=128,
        )
        if self.attn_kind == "mla":
            kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16)
        if self.n_experts:
            kw.update(n_experts=4, top_k=2, expert_d_ff=32)
        if self.window:
            kw.update(window=16)
        if self.family in ("hybrid",):
            kw.update(ssm_state=4)
        if self.rwkv:
            kw.update(rwkv_lora_w=8)
        return self.replace(**kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # lazy import so ``import repro_torch.configs`` registers every module once
    from repro_torch import configs as _c  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)
