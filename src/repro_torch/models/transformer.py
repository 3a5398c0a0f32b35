"""Model assembly for the dense GQA, MoE, RWKV6, hybrid (hymba:
sliding-window attention beside Mamba) and encoder (hubert: bidirectional
attention over frame embeddings) families (port of those parts of
``repro.models.transformer``).

Parameters are the reference's dict tree with layers stacked on a leading L
axis (``transformer.py:534-535``), so a JAX ``Model.init`` tree carries over
by copy (``repro_torch.convert``).  The reference scans the stacked layers
with ``lax.scan``; here a Python loop walks per-layer views.  Decode,
chunked prefill and cache writes update the paged pool or the slot cache
(for RWKV6 and Mamba, the recurrent state) in place instead of returning a
new one.

The sampling helpers (``lane_keys`` .. ``sample_from_dist``) and the
speculative ones (``rejection_choose``, ``ngram_propose``) are the
reference's, on ``repro_torch.models.prng``'s copy of ``jax.random``'s
threefry: the same seeds give the same keys, draws and tokens.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import prng
from repro_torch.models import ssm as S
from repro_torch.models.sharding import ShardPlan

NEG_INF = -1e30


def _norm(x, w, cfg: ArchConfig):
    if cfg.norm_kind == "layer":
        return L.layer_norm(x, w["scale"], w["bias"])
    return L.rms_norm(x, w["scale"], plus_one=cfg.norm_plus_one)


def _norm_init(cfg: ArchConfig, dt, device) -> dict:
    fill = torch.zeros if cfg.norm_plus_one else torch.ones
    p = {"scale": fill(cfg.d_model, dtype=dt, device=device)}
    if cfg.norm_kind == "layer":
        p["bias"] = torch.zeros(cfg.d_model, dtype=dt, device=device)
    return p


def _ported(cfg: ArchConfig) -> bool:
    """The blocks this module ports.  On token inputs with RMSNorm: causal
    GQA + a gated MLP or a MoE layer of gated experts; RWKV6 time-mix +
    channel-mix; and the hybrid block, sliding-window attention beside
    Mamba + a gated MLP.  On frame embeddings with LayerNorm: the encoder
    block, bidirectional GQA + a two-layer GELU MLP."""
    if cfg.family == "encoder":
        return (cfg.input_kind == "embeds" and cfg.norm_kind == "layer"
                and cfg.attn_kind == "gqa" and not cfg.causal
                and cfg.mlp_kind == "gelu2" and not cfg.tie_embeddings)
    if cfg.norm_kind != "rms" or cfg.input_kind != "tokens":
        return False
    if cfg.rwkv:
        return cfg.mlp_kind == "rwkv_cmix"
    attn = "swa" if cfg.family == "hybrid" else "gqa"
    return cfg.attn_kind == attn and cfg.causal and cfg.mlp_kind == "glu"


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------

def init_layer(cfg: ArchConfig, plan: ShardPlan, *,
               generator: torch.Generator, device="cuda") -> dict:
    dt = plan.param_dtype
    p = {"norm1": _norm_init(cfg, dt, device),
         "norm2": _norm_init(cfg, dt, device)}
    if cfg.rwkv:
        p["tmix"] = S.init_rwkv_tmix(cfg, plan, generator=generator,
                                     device=device)
        p["cmix"] = S.init_rwkv_cmix(cfg, plan, generator=generator,
                                     device=device)
        return p
    p["attn"] = A.init_gqa(cfg, plan, generator=generator, device=device)
    if cfg.family == "hybrid":
        p["mamba"] = S.init_mamba(cfg, plan, generator=generator,
                                  device=device)
    if cfg.n_experts:
        p["moe"] = M.init_moe(cfg, plan, generator=generator, device=device)
    elif cfg.mlp_kind == "gelu2":
        p["mlp"] = L.gelu_mlp_init(cfg.d_model, cfg.d_ff, generator=generator,
                                   dtype=dt, device=device)
    else:
        p["mlp"] = L.mlp_init(cfg.d_model, cfg.d_ff, generator=generator,
                              dtype=dt, device=device)
    return p


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mlp(h, lp: dict, cfg: ArchConfig, plan: ShardPlan):
    """The block's feed-forward, the MoE layer, the two-layer GELU MLP or
    the gated MLP, on (B, S, d) or on the decode blocks' one token per row
    (B, d)."""
    if cfg.n_experts:
        if h.dim() == 2:
            return M.moe_ffn(lp["moe"], h[:, None], cfg, plan)[:, 0]
        return M.moe_ffn(lp["moe"], h, cfg, plan)
    w = {k: v.to(plan.compute_dtype) for k, v in lp["mlp"].items()}
    if cfg.mlp_kind == "gelu2":
        return L.gelu_mlp(h, w)
    return L.glu_mlp(h, w, activation=cfg.activation)


def block_forward(x, lp: dict, positions, cfg: ArchConfig, plan: ShardPlan,
                  *, want_cache: bool):
    """Prefill block, x (B, S, d).  Returns (x, cache_or_None); an RWKV
    block starts from a zero state and its cache is the new state."""
    if cfg.rwkv:
        y, tmix = S.rwkv_tmix_forward(lp["tmix"], _norm(x, lp["norm1"], cfg),
                                      cfg, plan)
        x = x + y
        y, cmix = S.rwkv_cmix_forward(lp["cmix"], _norm(x, lp["norm2"], cfg),
                                      cfg, plan)
        x = x + y
        return x, ({"tmix": tmix, "cmix": cmix} if want_cache else None)
    h = _norm(x, lp["norm1"], cfg)
    attn_out, attn_cache = A.gqa_forward(lp["attn"], h, positions, cfg, plan,
                                         want_cache=want_cache)
    cache = {"attn": attn_cache}
    if cfg.family == "hybrid":
        mamba_out, cache["mamba"] = S.mamba_forward(lp["mamba"], h, cfg, plan)
        x = x + 0.5 * (attn_out + mamba_out)
    else:
        x = x + attn_out
    x = x + _mlp(_norm(x, lp["norm2"], cfg), lp, cfg, plan)
    return x, (cache if want_cache else None)


def block_prefill_paged(x, lp: dict, lc: dict, starts, lengths,
                        block_tables, cfg: ArchConfig, plan: ShardPlan):
    """Chunked-prefill block over the paged pool, x (B, C, d); lc holds
    this layer's pool slice, written in place."""
    h = _norm(x, lp["norm1"], cfg)
    attn_out, attn_cache = A.gqa_prefill_paged(lp["attn"], h, lc["attn"],
                                               starts, lengths, block_tables,
                                               cfg, plan)
    x = x + attn_out
    x = x + _mlp(_norm(x, lp["norm2"], cfg), lp, cfg, plan)
    return x, {"attn": attn_cache}


def block_decode(x, lp: dict, lc: dict, positions, cfg: ArchConfig,
                 plan: ShardPlan):
    """Slot-cache decode block, x (B, d); lc holds this layer's cache (for
    RWKV6 its recurrent state; for the hybrid block the ring and the Mamba
    state), written in place."""
    if cfg.rwkv:
        x3 = x[:, None]
        y, _ = S.rwkv_tmix_forward(lp["tmix"], _norm(x3, lp["norm1"], cfg),
                                   cfg, plan, lc["tmix"], out_state=lc["tmix"])
        x3 = x3 + y
        y, _ = S.rwkv_cmix_forward(lp["cmix"], _norm(x3, lp["norm2"], cfg),
                                   cfg, plan, lc["cmix"], out_state=lc["cmix"])
        return (x3 + y)[:, 0], lc
    h = _norm(x, lp["norm1"], cfg)
    attn_out, _ = A.gqa_decode(lp["attn"], h, lc["attn"], positions, cfg,
                               plan)
    if cfg.family == "hybrid":
        mamba_out, _ = S.mamba_decode(lp["mamba"], h, lc["mamba"], cfg, plan,
                                      out_state=lc["mamba"])
        x = x + 0.5 * (attn_out + mamba_out)
    else:
        x = x + attn_out
    x = x + _mlp(_norm(x, lp["norm2"], cfg), lp, cfg, plan)
    return x, lc


def block_decode_paged(x, lp: dict, lc: dict, positions, block_tables,
                       cfg: ArchConfig, plan: ShardPlan,
                       plan_lanes: int | None = None):
    """Paged decode block, x (B, d); lc holds this layer's pool slice."""
    h = _norm(x, lp["norm1"], cfg)
    attn_out, attn_cache = A.gqa_decode_paged(lp["attn"], h, lc["attn"],
                                              positions, block_tables,
                                              cfg, plan, plan_lanes)
    x = x + attn_out
    x = x + _mlp(_norm(x, lp["norm2"], cfg), lp, cfg, plan)
    return x, {"attn": attn_cache}


def _layer(tree: dict, i: int) -> dict:
    """Views of layer ``i`` of a layer-stacked tree."""
    return L.tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

# Salts folded into per-lane PRNG keys so every sampling event at one
# sequence index draws from a distinct stream.  Keys fold the ABSOLUTE
# sequence index of the token being decided, which makes streams
# replay-stable across preemption and horizon re-splits.
SALT_SAMPLE = 0   # non-speculative draws (scan step / first prefill token)
SALT_DRAFT = 1    # drafter proposal draws
SALT_ACCEPT = 2   # rejection-sampling accept uniforms
SALT_BONUS = 3    # residual / bonus draws after the accepted prefix


def lane_keys(seeds: torch.Tensor) -> torch.Tensor:
    """Per-lane base PRNG keys from int32 seeds: (B,) -> (B, 2) (uint32
    words in int64), ``jax.random.PRNGKey`` of each seed."""
    return prng.prng_key(seeds)


def event_keys(base_keys: torch.Tensor, seq_idx: torch.Tensor,
               salt: int) -> torch.Tensor:
    """``fold(fold(base, seq_idx), salt)`` per lane.

    base_keys: (B, 2); seq_idx: (B,) or (B, Q) absolute sequence index of
    the token the event decides.  Returns keys of seq_idx.shape + (2,)."""
    if seq_idx.dim() == 2:
        base_keys = base_keys[:, None, :].expand(*seq_idx.shape, 2)
    return prng.fold_in(prng.fold_in(base_keys, seq_idx), salt)


def uniform_lanes(keys: torch.Tensor) -> torch.Tensor:
    """One U[0, 1) draw per key; keys: (..., 2) -> (...) float32."""
    return prng.uniform(keys, 1)[..., 0]


def _one_hot(idx: torch.Tensor, V: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over V classes, by comparison (no host check
    of the class range, so it can run inside a CUDA graph capture)."""
    return (torch.arange(V, device=idx.device)
            == idx[..., None]).to(torch.float32)


def sampling_dist(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor) -> torch.Tensor:
    """Per-lane warped sampling distribution over the real vocab.

    logits: (..., V) already sliced to the real vocab; temps/top_ks:
    (...,).  Lanes with ``temps <= 0`` get a ONE-HOT argmax distribution;
    ``top_ks <= 0`` disables top-k truncation, and the k-th value is taken
    at ``top_ks - 1`` clipped into [0, V - 1].  Returns float32 probs."""
    logits = logits.float()
    V = logits.shape[-1]
    greedy = temps <= 0.0
    top = torch.sort(logits, dim=-1, descending=True).values
    kth = top.gather(-1, (top_ks.long() - 1).clamp(0, V - 1)[..., None])
    keep = (logits >= kth) | (top_ks <= 0)[..., None]
    t = torch.where(greedy, 1.0, temps.clamp_min(1e-6))[..., None]
    probs = torch.softmax(torch.where(keep, logits / t, NEG_INF), dim=-1)
    return torch.where(greedy[..., None], _one_hot(logits.argmax(dim=-1), V),
                       probs)


def sample_from_dist(keys: torch.Tensor, probs: torch.Tensor,
                     greedy: torch.Tensor) -> torch.Tensor:
    """One token per lane from ``probs``; greedy lanes take the argmax
    EXACTLY (categorical over a one-hot is only almost-surely the argmax).

    keys: (..., 2); probs: (..., V); greedy: (...,) bool -> (...) int32."""
    drawn = prng.categorical(keys, torch.log(probs + 1e-30))
    return torch.where(greedy, probs.argmax(dim=-1), drawn).to(torch.int32)


def rejection_choose(base_keys, pos_eff, drafts, q_dists, p_dists, greedy,
                     n_valid):
    """Standard speculative rejection sampling, vectorised per lane.

    drafts: (B, K) proposal tokens with proposal dists ``q_dists``
    (B, K, V); ``p_dists``: (B, K+1, V) target dists for every slot.
    Draft j is accepted iff ``u_j * q_j(d_j) < p_j(d_j)`` with u_j ~
    U[0, 1) keyed on the token's absolute slot index (SALT_ACCEPT); the
    token at the first rejected slot is drawn from the renormalised
    residual ``max(p - q, 0)`` (SALT_BONUS), falling back to p when the
    residual vanishes (q == p); slot K has q = 0, so its "residual" is
    the plain bonus draw from p.  The emitted-token marginal at every
    consumed slot equals p exactly; greedy lanes (one-hot dists) accept
    iff the draft is the argmax and correct with the argmax.

    Returns ``(n_acc (B,) int32 accepted-prefix length, capped at
    max(n_valid - 1, 0) so the bonus slot stays in range, cand_out
    (B, K+1) int32 the would-be emitted token per slot)``."""
    B, spec_k = drafts.shape
    K1 = spec_k + 1
    V = p_dists.shape[-1]
    d = drafts.long()[..., None]
    p_d = p_dists[:, :spec_k].gather(2, d)[..., 0]
    q_d = q_dists.gather(2, d)[..., 0]
    j = torch.arange(K1, dtype=torch.int32, device=drafts.device)[None, :]
    u = uniform_lanes(event_keys(base_keys, pos_eff[:, None] + 1
                                 + j[:, :spec_k], SALT_ACCEPT))
    accept = u * q_d < p_d
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    n_acc = torch.minimum(n_acc, (n_valid - 1).clamp_min(0)).to(torch.int32)
    q_ext = torch.cat([q_dists, q_dists.new_zeros(B, 1, V)], dim=1)
    resid = (p_dists - q_ext).clamp_min(0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rsum > 1e-9, resid / rsum.clamp_min(1e-30), p_dists)
    corr = sample_from_dist(event_keys(base_keys, pos_eff[:, None] + 1 + j,
                                       SALT_BONUS),
                            resid, greedy[:, None].expand(B, K1))
    d_ext = torch.cat([drafts, drafts.new_zeros(B, 1)], dim=1)
    cand_out = torch.where(j < n_acc[:, None], d_ext, corr)
    return n_acc, cand_out.to(torch.int32)


def ngram_propose(hist, positions, *, k: int, n: int = 2):
    """Prompt-lookup drafting (drafter-free speculation).

    Match the n-token suffix ending at ``positions`` against every earlier
    window of the sequence history and propose the k tokens that followed
    the MOST RECENT match; with no match (or too little history) repeat
    the current last token.  hist: (B, S) int32, ``hist[b, i]`` = i-th
    sequence token, valid through ``positions[b]``; returns (B, k) int32.
    """
    B, S = hist.shape
    dev = hist.device
    pos = positions.long()
    last = hist.gather(1, pos.clamp(0, S - 1)[:, None])
    nw = S - n
    if nw <= 0:
        return last.expand(B, k).to(torch.int32)
    windows = torch.stack([hist[:, j:nw + j] for j in range(n)], dim=-1)
    suf_idx = (pos[:, None] - (n - 1)
               + torch.arange(n, device=dev)[None, :]).clamp(0, S - 1)
    suffix = hist.gather(1, suf_idx)
    starts = torch.arange(nw, device=dev)
    match = (windows == suffix[:, None, :]).all(dim=-1)
    # the window must END strictly before the suffix itself (start <=
    # pos - n), which also keeps its continuation a known token
    match &= starts[None, :] <= pos[:, None] - n
    best = torch.where(match, starts[None, :], -1).amax(dim=1)
    cont_idx = torch.minimum(best[:, None] + n
                             + torch.arange(k, device=dev)[None, :],
                             pos[:, None])
    drafts = hist.gather(1, cont_idx.clamp(0, S - 1))
    return torch.where(best[:, None] >= 0, drafts, last).to(torch.int32)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model:
    """One dense GQA, MoE, RWKV6, hybrid or encoder architecture bound to a
    plan and a device."""

    def __init__(self, cfg: ArchConfig, plan: ShardPlan, device="cuda"):
        if not _ported(cfg):
            raise NotImplementedError(f"{cfg.name} ({cfg.family}, "
                                      f"attn_kind={cfg.attn_kind!r}) is not "
                                      f"ported yet")
        if cfg.n_experts and plan.tp > 1:
            raise NotImplementedError(
                f"{cfg.name}: MoE at shards > 1 (the reference's expert "
                f"parallelism) is not ported yet (ROADMAP.md, Queue 1 item "
                f"12)")
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
        p = {}
        if cfg.input_kind == "tokens":   # frame embeddings need no table
            p["embed"] = L.embed_init((cfg.vocab_size, cfg.d_model), dtype=dt,
                                      **kw)
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
        """Token ids through the embedding table, or frame embeddings
        (B, S, d) cast to the compute dtype."""
        cfg, dt = self.cfg, self.plan.compute_dtype
        if cfg.input_kind == "embeds":
            x = inputs.to(dt)
        else:
            x = L.take_embedding(params["embed"], inputs).to(dt)
        if cfg.embed_scale:
            # sqrt(d_model) rounded to the compute dtype, as the reference
            # rounds it; filled on the device (no host copy), so a CUDA
            # graph can capture it
            x = x * torch.full((), math.sqrt(cfg.d_model), dtype=dt,
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
        return x, L.tree_map(lambda *a: torch.stack(a), *caches)

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

    def _no_decode(self) -> None:
        if self.cfg.input_kind == "embeds":
            raise ValueError(f"{self.cfg.name} is encoder-only: no decode "
                             f"step")

    def logits(self, params, inputs):
        """Full-sequence logits: the encoder's forward (frames in, per-frame
        logits out); for the decoders small inputs / tests only."""
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

    def prefill_chunk_paged(self, params, cache, tokens, starts, lengths,
                            block_tables):
        """One chunked-prefill step over the paged pool (updated in place).

        tokens: (B, C) the next C context tokens per row, row b valid for
        its first lengths[b]; starts: (B,) absolute position of tokens[:, 0]
        (earlier chunks and prefix-shared blocks already sit in the pool);
        block_tables: (B, T).  Returns (logits at each row's last valid
        chunk token (B, V_pad), cache)."""
        cfg, plan = self.cfg, self.plan
        if plan.paged_pool_sharded(cfg):
            raise NotImplementedError(
                "chunked prefill over a block-striped pool needs the "
                "reference's _paged_prefill_core with an owned/LSE form of "
                "kernel 3, not ported yet (ROADMAP.md, Queue 1 item 12)")
        x = self._embed_inputs(params, tokens)
        for i in range(cfg.num_layers):
            x, _ = block_prefill_paged(x, _layer(params["layers"], i),
                                       _layer(cache, i), starts, lengths,
                                       block_tables, cfg, plan)
        x = _norm(x, params["final_norm"], cfg)
        rows = torch.arange(x.shape[0], device=x.device)
        return self._head(params, x[rows, (lengths - 1).clamp_min(0).long()]), \
            cache

    def decode_step(self, params, cache, tokens, positions):
        """One token per slot over the contiguous slot cache (for a sliding
        window its ring), and for RWKV6 and Mamba the slots' recurrent
        state, updated in place (the WKV kernel writes its final state over
        the pool's).  tokens/positions: (B,) int32.

        The reference returns the new RWKV shift state in the compute
        dtype and the new Mamba conv state in the dtype promoted from the
        pool's and the compute dtype, so a pool's leaf in another dtype
        (bf16 under an f32 plan) is replaced by a copy in that dtype at the
        first step, in ``cache`` itself."""
        self._no_decode()
        cfg, plan = self.cfg, self.plan
        leaves = [(cache[part], "shift") for part in ("tmix", "cmix")] \
            if cfg.rwkv else []
        if cfg.family == "hybrid":
            leaves.append((cache["mamba"], "conv"))
        for tree, name in leaves:
            want = plan.compute_dtype if cfg.rwkv else torch.promote_types(
                tree[name].dtype, plan.compute_dtype)
            if tree[name].dtype != want:
                tree[name] = tree[name].to(want)
        x = self._embed_inputs(params, tokens)
        for i in range(cfg.num_layers):
            x, _ = block_decode(x, _layer(params["layers"], i),
                                _layer(cache, i), positions, cfg, plan)
        x = _norm(x, params["final_norm"], cfg)
        return self._head(params, x), cache

    def decode_step_paged(self, params, cache, tokens, positions,
                          block_tables, plan_lanes: int | None = None):
        """One token per lane over the paged pool (updated in place).
        tokens/positions: (B,) int32; block_tables: (B, T) int32.
        ``plan_lanes`` pins the decode kernels' split plan to that of so
        many lanes (``decode_verify_paged``'s fold)."""
        self._no_decode()
        cfg, plan = self.cfg, self.plan
        x = self._embed_inputs(params, tokens)
        for i in range(cfg.num_layers):
            x, _ = block_decode_paged(x, _layer(params["layers"], i),
                                      _layer(cache, i), positions,
                                      block_tables, cfg, plan, plan_lanes)
        x = _norm(x, params["final_norm"], cfg)
        return self._head(params, x), cache

    def next_tokens(self, logits, seq_idx, temps=None, top_ks=None,
                    base_keys=None):
        """Each lane's next token from its logits (B, V_pad): the argmax
        over the real vocab, or with ``temps``/``top_ks`` (B,) and
        ``base_keys`` (B, 2) (``lane_keys``) a draw from the warped
        distribution under ``event_keys(base_keys, seq_idx,
        SALT_SAMPLE)``, greedy lanes (``temps <= 0``) the exact argmax.
        -> (B,) int32."""
        logits = logits[:, :self.cfg.vocab_size]
        if temps is None:
            return logits.argmax(dim=-1).to(torch.int32)
        dist = sampling_dist(logits, temps, top_ks)
        keys = event_keys(base_keys, seq_idx, SALT_SAMPLE)
        return sample_from_dist(keys, dist, temps <= 0.0)

    def horizon_step(self, params, cache, tokens, positions, active,
                     budgets, block_tables, eos_ids, max_len: int,
                     temps=None, top_ks=None, base_keys=None):
        """One live step of ``decode_multi_paged``'s loop: decode every
        lane (inactive ones parked at position 0 through table row 0),
        pick each lane's token with ``next_tokens`` at sequence index
        ``positions + 1``, and advance the lane state ``tokens``,
        ``positions``, ``active`` and ``budgets`` IN PLACE.  Allocates on
        the device only and never reads back, so a CUDA graph can capture
        it (``serving.graphs``).  Returns ``(nxt, emitted, logits)``."""
        pos_eff = torch.where(active, positions, 0)
        bt_eff = torch.where(active[:, None], block_tables, 0)
        logits, _ = self.decode_step_paged(params, cache, tokens, pos_eff,
                                           bt_eff)
        nxt = self.next_tokens(logits, positions + 1, temps, top_ks,
                               base_keys)
        emitted = active.clone()
        left = budgets - emitted.to(torch.int32)
        done = emitted & ((left <= 0) | (nxt == eos_ids)
                          | (positions + 1 >= max_len))
        tokens.copy_(torch.where(emitted, nxt, tokens))
        positions.add_(emitted.to(torch.int32))
        active.copy_(active & ~done)
        budgets.copy_(left)
        return nxt, emitted, logits

    def decode_multi_paged(self, params, cache, tokens, positions,
                           block_tables, active, budgets, eos_ids,
                           num_steps: int, max_len: int, temps=None,
                           top_ks=None, seeds=None):
        """Multi-step decode over the paged pool.

        Runs ``num_steps`` decode steps (``horizon_step``) with every piece
        of lane state on the device; the caller reads ``(out_tokens,
        emitted)`` back once.  Lanes that are inactive, or finish
        mid-horizon, decode at position 0 through table row 0 (the parking
        block).  Where the reference skips a step in which every lane has
        drained (``lax.cond``), this loop runs it parked: no lane emits, so
        the emitted tokens, the final state and every live block are the
        same, and no host sync is needed to decide.

        tokens/positions/budgets/eos_ids: (B,) int32 (eos -1 = none);
        active: (B,) bool; the inputs are not modified.  With ``temps``/
        ``top_ks``/``seeds`` (all (B,)) set, each step's token is drawn
        from the temperature/top-k-warped distribution with a key folded
        from the lane seed and the token's absolute sequence index
        (replay-stable); lanes with ``temps[b] <= 0`` still take the exact
        argmax.  ``temps=None`` is the greedy path.  Returns
        ``(out_tokens (N, B), emitted (N, B) bool, last_logits (B, V_pad),
        (tokens, positions, active, budgets), cache)``; token [i, b] is
        valid iff emitted[i, b].
        """
        self._no_decode()
        state = [t.clone() for t in (tokens, positions, active, budgets)]
        base_keys = lane_keys(seeds) if temps is not None else None
        logits = torch.zeros(tokens.shape[0], params["embed"].shape[0],
                             dtype=self.plan.compute_dtype,
                             device=tokens.device)
        outs, ems = [], []
        for _ in range(num_steps):
            nxt, emitted, logits = self.horizon_step(
                params, cache, *state, block_tables, eos_ids, max_len,
                temps, top_ks, base_keys)
            outs.append(nxt)
            ems.append(emitted)
        return (torch.stack(outs), torch.stack(ems), logits, tuple(state),
                cache)

    def decode_verify_paged(self, params, cache, tokens, positions,
                            block_tables, n_valid):
        """Target forward over Q candidate tokens per lane in ONE paged
        pass (speculative verify): the current input token plus K drafts,
        token i at absolute position ``positions[b] + i``.

        The Q candidates fold into the lane axis: candidate i becomes a
        pseudo-lane at position ``positions[b] + i`` sharing lane b's
        block-table row, and all B * Q run through ``decode_step_paged``
        verbatim, so kernel 2 (kernel 4 stripe by stripe on a sharded
        pool) carries verify.  All Q keys are written into the pool
        before the (position-masked) attention reads it, so candidate i
        sees candidates < i causally.  The fold pins the decode kernels'
        split plan to the un-folded batch's (``plan_lanes=B``): a
        candidate's attention then has the bits of a B-lane decode step
        at its position, where the plan of B * Q lanes would split the
        walk otherwise and round differently.

        Tokens at index >= ``n_valid[b]`` are routed to the parking block
        (their logits are garbage; callers ignore them).  Returns (logits
        (B, Q, V_pad), ``logits[b, i]`` predicting position ``positions[b]
        + i + 1``, and the cache)."""
        B, Q = tokens.shape
        j = torch.arange(Q, dtype=torch.int32, device=tokens.device)
        valid = j[None, :] < n_valid[:, None]
        pos = torch.where(valid, positions[:, None] + j[None, :], 0)
        tab = torch.where(valid[..., None], block_tables[:, None, :], 0)
        logits, cache = self.decode_step_paged(
            params, cache, tokens.reshape(B * Q), pos.reshape(B * Q),
            tab.reshape(B * Q, tab.shape[-1]), plan_lanes=B)
        return logits.reshape(B, Q, logits.shape[-1]), cache

    def spec_round(self, drafter, params, cache, d_params, d_cache, hist,
                   tokens, positions, active, budgets, block_tables,
                   eos_ids, temps, top_ks, base_keys, *, spec_k: int,
                   max_len: int, ngram: int = 2):
        """One live round of ``decode_spec_paged``: propose ``spec_k``
        drafts per lane (``ngram_propose`` over ``hist``, or ``spec_k``
        decode steps of ``drafter`` over ``d_cache`` plus the backfill
        step), verify the current token and the drafts in one target pass
        (``decode_verify_paged``), choose the accepted prefix and one
        corrected or bonus token (``rejection_choose``; greedy lanes,
        ``temps <= 0``, take one-hot dists), and advance the lane state
        ``tokens``, ``positions``, ``active``, ``budgets`` and ``hist`` IN
        PLACE by the emitted run.  ``base_keys`` are ``lane_keys`` of the
        lane seeds.  The pool and the draft pool are written in place too.
        Allocates
        on the device only and never reads back, so a CUDA graph can
        capture it (``serving.graphs``).  Inactive lanes decode parked
        (position 0, table row 0) and emit nothing.  Returns ``(cand_out
        (B, K+1), emit (B, K+1) bool, n_acc (B,))``."""
        V = self.cfg.vocab_size
        B, K1 = tokens.shape[0], spec_k + 1
        greedy = temps <= 0.0
        pos_eff = torch.where(active, positions, 0)
        bt_eff = torch.where(active[:, None], block_tables, 0)

        # ---- propose spec_k draft tokens (+ their proposal dists q)
        if drafter is None:
            drafts = ngram_propose(hist, pos_eff, k=spec_k, n=ngram)
            q_dists = _one_hot(drafts, V)
        else:
            cur, ds, qs = tokens, [], []
            for j in range(spec_k):
                p_j = (pos_eff + j).clamp_max(max_len - 1)
                lg, _ = drafter.decode_step_paged(d_params, d_cache, cur, p_j,
                                                  bt_eff)
                qd = sampling_dist(lg[:, :V], temps, top_ks)
                cur = sample_from_dist(
                    event_keys(base_keys, pos_eff + j + 1, SALT_DRAFT), qd,
                    greedy)
                ds.append(cur)
                qs.append(qd)
            # backfill d_K so the drafter cache has no hole next round
            drafter.decode_step_paged(
                d_params, d_cache, cur,
                (pos_eff + spec_k).clamp_max(max_len - 1), bt_eff)
            drafts = torch.stack(ds, dim=1)
            q_dists = torch.stack(qs, dim=1)

        # ---- verify all spec_k + 1 positions in one target pass
        cand_in = torch.cat([tokens[:, None], drafts], dim=1)
        n_valid = torch.where(active, (max_len - pos_eff).clamp(0, K1), 0)
        logits, _ = self.decode_verify_paged(params, cache, cand_in, pos_eff,
                                             bt_eff, n_valid)
        logits = logits[..., :V]

        # ---- the accepted prefix + correction/bonus
        p_dists = sampling_dist(logits, temps[:, None].expand(B, K1),
                                top_ks[:, None].expand(B, K1))
        n_acc, cand_out = rejection_choose(base_keys, pos_eff, drafts,
                                           q_dists, p_dists, greedy, n_valid)

        # ---- stop flags, replicating the horizon step's semantics: slot
        # j is this round's (j+1)-th emission
        j = torch.arange(K1, dtype=torch.int32, device=tokens.device)[None, :]
        stop = ((budgets[:, None] - (j + 1) <= 0)
                | (cand_out == eos_ids[:, None])
                | (pos_eff[:, None] + j + 1 >= max_len))
        n_stop = torch.cumsum(stop.to(torch.int32), dim=1)
        stopped_before = (n_stop - stop.to(n_stop.dtype)) > 0
        emit = active[:, None] & (j <= n_acc[:, None]) & ~stopped_before
        done = (emit & stop).any(dim=1)
        m = emit.sum(dim=1).to(torch.int32)

        # ---- advance the lane state by the emitted run (a prefix of the
        # slots): hist[pos_eff + 1 + i] = cand_out[i] for i < m, the
        # reference's dropping scatter as a gather, so no write is lost
        # or repeated
        last_tok = cand_out.gather(1, (m - 1).clamp_min(0).long()[:, None])
        S = hist.shape[1]
        off = (torch.arange(S, device=hist.device)[None, :]
               - pos_eff.long()[:, None] - 1)
        take = (off >= 0) & (off < m[:, None])
        hist.copy_(torch.where(take, cand_out.gather(
            1, off.clamp(0, spec_k)), hist))
        tokens.copy_(torch.where(m > 0, last_tok[:, 0], tokens))
        positions.add_(m)
        budgets.sub_(m)
        active.copy_(active & ~done)
        return cand_out, emit, n_acc

    def decode_spec_paged(self, drafter, params, cache, d_params, d_cache,
                          hist, tokens, positions, block_tables, active,
                          budgets, eos_ids, temps, top_ks, seeds, *,
                          num_steps: int, spec_k: int, max_len: int,
                          ngram: int = 2):
        """Speculative decode over the paged pool: ``num_steps`` rounds of
        ``spec_round`` (drafts from ``drafter``, a paired smaller Model
        whose paged cache ``d_cache`` shares this pool's block tables, or
        with ``drafter`` None from n-gram prompt lookup over ``hist``),
        every lane sampled from ``temps``/``top_ks`` under ``seeds``
        (greedy lanes, ``temps <= 0``, take one-hot dists, so acceptance
        is exact argmax agreement and the stream is
        ``decode_multi_paged``'s).

        Rejected tails need no KV rollback: position p is the next write
        slot, so a stale slot is rewritten when that position is consumed
        again; positions, budgets and the history advance by emitted
        tokens only.  Blocks for spec_k + 1 writes per round must be
        allocated (``ensure_append_blocks`` with the padded horizon).
        Where the reference skips a round in which every lane has drained
        (``lax.cond``), this loop runs it parked: nothing is emitted.

        The inputs are not modified; the pools are written in place.
        Returns ``(out_tokens (N, B, spec_k+1), emitted (N, B, spec_k+1)
        bool, n_acc (N, B) accepted drafts per round, (tokens, positions,
        active, budgets) final state, cache, d_cache, hist)``."""
        self._no_decode()
        state = [t.clone() for t in (tokens, positions, active, budgets)]
        hist = hist.clone()
        base_keys = lane_keys(seeds)
        outs = [self.spec_round(drafter, params, cache, d_params, d_cache,
                                hist, *state, block_tables, eos_ids, temps,
                                top_ks, base_keys, spec_k=spec_k,
                                max_len=max_len, ngram=ngram)
                for _ in range(num_steps)]
        cand, emitted, n_acc = (torch.stack(x) for x in zip(*outs))
        return (cand, emitted, n_acc, tuple(state), cache, d_cache, hist)

    # ----- cache -----
    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16,
                   device="cuda") -> dict:
        """Layer-stacked slot cache on ``device`` (the slot pool passes the
        model's): leaves (L, batch, seq_len, K, hd), for a sliding window
        its ring (L, batch, min(window, seq_len), K, hd); for RWKV6 the
        recurrent state, ``{"tmix": {"shift", "wkv"}, "cmix": {"shift"}}``
        with leaves (L, batch, ...), the WKV state in f32; the hybrid
        family adds ``"mamba": {"conv", "ssm"}``, the SSM state in f32."""
        cfg, plan = self.cfg, self.plan
        if cfg.rwkv:
            one = S.init_rwkv_state(cfg, plan, batch, dtype, device="meta")
        else:
            one = {"attn": A.init_attn_cache(cfg, plan, batch, seq_len, dtype,
                                             device="meta")}
            if cfg.family == "hybrid":
                one["mamba"] = S.init_mamba_state(cfg, plan, batch, dtype,
                                                  device="meta")
        return L.tree_map(lambda a: torch.zeros((cfg.num_layers,) + a.shape,
                                                dtype=a.dtype, device=device),
                          one)

    def init_paged_cache(self, n_blocks: int, block_size: int,
                         dtype=torch.bfloat16) -> dict:
        """Layer-stacked paged KV pool: leaves (L, n_blocks, bs, K, hd).
        Under a sharded plan ``n_blocks`` must divide into ``tp`` stripes;
        rank r's stripe of layer i is the contiguous view
        ``leaf[i, r*nb_loc:(r+1)*nb_loc]``."""
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
