"""Model assembly for the dense GQA family (port of the dense parts of
``repro.models.transformer``).

Parameters are the reference's dict tree with layers stacked on a leading L
axis (``transformer.py:534-535``), so a JAX ``Model.init`` tree carries over
by copy (``repro_torch.convert``).  The reference scans the stacked layers
with ``lax.scan``; here a Python loop walks per-layer views.  Decode and
cache writes update the paged pool in place instead of returning a new one.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.sharding import ShardPlan

NEG_INF = -1e30


def _norm(x, w, cfg: ArchConfig):
    return L.rms_norm(x, w["scale"], plus_one=cfg.norm_plus_one)


def _norm_init(cfg: ArchConfig, dt, device) -> dict:
    fill = torch.zeros if cfg.norm_plus_one else torch.ones
    return {"scale": fill(cfg.d_model, dtype=dt, device=device)}


def _ported(cfg: ArchConfig) -> bool:
    """The blocks this module ports: causal GQA + RMSNorm + gated MLP on
    token inputs."""
    return (cfg.attn_kind == "gqa" and cfg.causal and not cfg.rwkv
            and cfg.family not in ("hybrid", "moe") and not cfg.n_experts
            and cfg.mlp_kind == "glu" and cfg.norm_kind == "rms"
            and cfg.input_kind == "tokens")


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------

def init_layer(cfg: ArchConfig, plan: ShardPlan, *,
               generator: torch.Generator, device="cuda") -> dict:
    dt = plan.param_dtype
    return {
        "norm1": _norm_init(cfg, dt, device),
        "norm2": _norm_init(cfg, dt, device),
        "attn": A.init_gqa(cfg, plan, generator=generator, device=device),
        "mlp": L.mlp_init(cfg.d_model, cfg.d_ff, generator=generator,
                          dtype=dt, device=device),
    }


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mlp(h, lp: dict, cfg: ArchConfig, plan: ShardPlan):
    w = {k: v.to(plan.compute_dtype) for k, v in lp["mlp"].items()}
    return L.glu_mlp(h, w, activation=cfg.activation)


def block_forward(x, lp: dict, positions, cfg: ArchConfig, plan: ShardPlan,
                  *, want_cache: bool):
    """Prefill block, x (B, S, d).  Returns (x, cache_or_None)."""
    h = _norm(x, lp["norm1"], cfg)
    attn_out, attn_cache = A.gqa_forward(lp["attn"], h, positions, cfg, plan,
                                         want_cache=want_cache)
    x = x + attn_out
    x = x + _mlp(_norm(x, lp["norm2"], cfg), lp, cfg, plan)
    return x, ({"attn": attn_cache} if want_cache else None)


def block_decode_paged(x, lp: dict, lc: dict, positions, block_tables,
                       cfg: ArchConfig, plan: ShardPlan):
    """Paged decode block, x (B, d); lc holds this layer's pool slice."""
    h = _norm(x, lp["norm1"], cfg)
    attn_out, attn_cache = A.gqa_decode_paged(lp["attn"], h, lc["attn"],
                                              positions, block_tables,
                                              cfg, plan)
    x = x + attn_out
    x = x + _mlp(_norm(x, lp["norm2"], cfg), lp, cfg, plan)
    return x, {"attn": attn_cache}


def _layer(tree: dict, i: int) -> dict:
    """Views of layer ``i`` of a layer-stacked tree."""
    return L.tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model:
    """One dense GQA architecture bound to a plan and a device."""

    def __init__(self, cfg: ArchConfig, plan: ShardPlan, device="cuda"):
        if not _ported(cfg):
            raise NotImplementedError(f"{cfg.name} ({cfg.family}, "
                                      f"attn_kind={cfg.attn_kind!r}) is not "
                                      f"ported yet")
        self.cfg = cfg
        self.plan = plan
        self.device = torch.device(device)

    # ----- params -----
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters from ``generator`` (on the model's device).
        Each tensor is drawn in f32 and stored in ``param_dtype`` layer by
        layer, so a bf16 model never holds an f32 copy of itself."""
        cfg, plan, dev = self.cfg, self.plan, self.device
        dt = plan.param_dtype
        kw = dict(generator=generator, device=dev)
        p = {"embed": L.embed_init((cfg.vocab_size, cfg.d_model), dtype=dt,
                                   **kw)}
        first = init_layer(cfg, plan, **kw)
        layers = L.tree_map(
            lambda a: torch.empty((cfg.num_layers,) + a.shape, dtype=a.dtype,
                                  device=dev), first)
        for i in range(cfg.num_layers):
            lp = first if i == 0 else init_layer(cfg, plan, **kw)
            L.tree_map(lambda dst, src: dst[i].copy_(src), layers, lp)
        p["layers"] = layers
        p["final_norm"] = _norm_init(cfg, dt, dev)
        if not cfg.tie_embeddings:
            p["unembed"] = L.dense_init((cfg.d_model, cfg.vocab_size),
                                        dtype=dt, **kw)
        return p

    def _unembed_w(self, params: dict):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["unembed"]

    # ----- embedding / trunk / head -----
    def _embed_inputs(self, params, inputs):
        cfg, dt = self.cfg, self.plan.compute_dtype
        x = L.take_embedding(params["embed"], inputs).to(dt)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt,
                                 device=x.device)
        return x

    def _trunk(self, params, x, positions, *, want_cache: bool):
        cfg, plan = self.cfg, self.plan
        caches = []
        for i in range(cfg.num_layers):
            x, cache = block_forward(x, _layer(params["layers"], i), positions,
                                     cfg, plan, want_cache=want_cache)
            caches.append(cache)
        x = _norm(x, params["final_norm"], cfg)
        if not want_cache:
            return x, None
        stacked = {name: torch.stack([c["attn"][name] for c in caches])
                   for name in ("k", "v")}
        return x, {"attn": stacked}

    def _head(self, params, x):
        w = self._unembed_w(params).to(self.plan.compute_dtype)
        logits = x @ w
        if logits.shape[-1] > self.cfg.vocab_size:   # padded vocab columns
            cols = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(cols < self.cfg.vocab_size, logits, NEG_INF)
        return logits

    def _positions(self, x):
        B, S = x.shape[:2]
        return torch.arange(S, device=x.device)[None, :].expand(B, S)

    def logits(self, params, inputs):
        """Full-sequence logits (small inputs / tests only)."""
        x = self._embed_inputs(params, inputs)
        x, _ = self._trunk(params, x, self._positions(x), want_cache=False)
        return self._head(params, x)

    # ----- serving -----
    @property
    def supports_paged(self) -> bool:
        cfg = self.cfg
        return (not cfg.rwkv and cfg.family != "hybrid"
                and cfg.attn_kind == "gqa" and cfg.causal
                and cfg.input_kind == "tokens")

    def prefill(self, params, inputs):
        """Returns (last-token logits (B, V_pad), cache stacked over layers)."""
        x = self._embed_inputs(params, inputs)
        x, caches = self._trunk(params, x, self._positions(x), want_cache=True)
        return self._head(params, x[:, -1]), caches

    def prefill_ragged(self, params, inputs, lengths):
        """Batched prefill over right-padded prompts of one bucket shape.

        inputs: (B, S_bucket) token ids, row b valid for its first
        lengths[b] tokens; returns logits at each row's true last token
        (B, V_pad) + the stacked cache.  Padded tail positions attend only
        causally, so each row's valid prefix is exact."""
        x = self._embed_inputs(params, inputs)
        x, caches = self._trunk(params, x, self._positions(x), want_cache=True)
        rows = torch.arange(x.shape[0], device=x.device)
        return self._head(params, x[rows, lengths.long() - 1]), caches

    def decode_step_paged(self, params, cache, tokens, positions,
                          block_tables):
        """One token per lane over the paged pool (updated in place).
        tokens/positions: (B,) int32; block_tables: (B, T) int32."""
        cfg, plan = self.cfg, self.plan
        x = self._embed_inputs(params, tokens)
        for i in range(cfg.num_layers):
            x, _ = block_decode_paged(x, _layer(params["layers"], i),
                                      _layer(cache, i), positions,
                                      block_tables, cfg, plan)
        x = _norm(x, params["final_norm"], cfg)
        return self._head(params, x), cache

    def decode_multi_paged(self, params, cache, tokens, positions,
                           block_tables, active, budgets, eos_ids,
                           num_steps: int, max_len: int):
        """Greedy multi-step decode over the paged pool.

        Runs ``num_steps`` decode steps with every piece of lane state on
        the device; the caller reads ``(out_tokens, emitted)`` back once.
        Lanes that are inactive, or finish mid-horizon, decode at position
        0 through table row 0 (the parking block).  Where the reference
        skips a step in which every lane has drained (``lax.cond``), this
        loop runs it parked: no lane emits, so the emitted tokens, the
        final state and every live block are the same, and no host sync is
        needed to decide.

        tokens/positions/budgets/eos_ids: (B,) int32 (eos -1 = none);
        active: (B,) bool.  Returns ``(out_tokens (N, B), emitted (N, B)
        bool, last_logits (B, V_pad), (tokens, positions, active, budgets),
        cache)``; token [i, b] is valid iff emitted[i, b].
        """
        V = self.cfg.vocab_size
        logits = torch.zeros(tokens.shape[0], params["embed"].shape[0],
                             dtype=self.plan.compute_dtype,
                             device=tokens.device)
        outs, ems = [], []
        for _ in range(num_steps):
            pos_eff = torch.where(active, positions, 0)
            bt_eff = torch.where(active[:, None], block_tables, 0)
            logits, cache = self.decode_step_paged(params, cache, tokens,
                                                   pos_eff, bt_eff)
            nxt = logits[:, :V].argmax(dim=-1).to(torch.int32)
            emitted = active
            budgets = budgets - emitted.to(torch.int32)
            done = emitted & ((budgets <= 0) | (nxt == eos_ids)
                              | (positions + 1 >= max_len))
            tokens = torch.where(emitted, nxt, tokens)
            positions = positions + emitted.to(torch.int32)
            active = active & ~done
            outs.append(nxt)
            ems.append(emitted)
        return (torch.stack(outs), torch.stack(ems), logits,
                (tokens, positions, active, budgets), cache)

    # ----- cache -----
    def init_paged_cache(self, n_blocks: int, block_size: int,
                         dtype=torch.bfloat16) -> dict:
        """Layer-stacked paged KV pool: leaves (L, n_blocks, bs, K, hd)."""
        c = A.init_paged_attn_cache(self.cfg, self.plan, n_blocks, block_size,
                                    dtype, device="meta")
        return {"attn": {name: torch.zeros((self.cfg.num_layers,) + a.shape,
                                           dtype=dtype, device=self.device)
                         for name, a in c.items()}}


def build_model(name_or_cfg, plan: ShardPlan, device="cuda") -> Model:
    from repro_torch.configs import get_config
    cfg = name_or_cfg if isinstance(name_or_cfg, ArchConfig) \
        else get_config(name_or_cfg)
    return Model(cfg, plan, device)
