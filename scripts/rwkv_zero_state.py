#!/usr/bin/env python3
"""Does the JAX reference amplify rounding in one rwkv6-3b step from a
zero state?  A CPU check of the reference alone (``src/repro``, f32).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/rwkv_zero_state.py

Full-width rwkv6-3b blocks (d_model 2560, 40 heads of 64, d_ff 8960;
random weights from ``jax.random.PRNGKey(seed)``, one layer made and
dropped at a time) run one token per lane from a zero state (the
reference's ``block_forward`` with no state: the first step of any
prompt, and a decode step from a fresh slot) in an f32 plan, on
embedding rows drawn as ``embed_init`` draws them, twice: with the
reference's ``_wkv_chunk`` (y summed over k by its einsum) and with the
same recurrence summed over k in reverse order.  After each layer it
prints the two residual streams' difference beside their scale; at the
end, the difference of the logits through the final norm and a random
unembedding (d_model x 65536).  Layer 0 also prints, per head, the rms of
the WKV output y, which the group norm (``ln_x``, an RMSNorm over the
head's 64 values, eps 1e-6) divides by.

From a zero state y = r . (u * k) v^T is rank one per head: y_j = c v_j
with c = sum_i r_i u_i k_i, and the group norm maps it to about sign(c)
v_j / rms(v), whatever |c|: a head with a small c carries a large
relative error of c into the layer's output unchanged in size.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import layers as L
from repro.models import local_plan
from repro.models import ssm as S
from repro.models import transformer as TR

_ORIG = S._wkv_chunk


def _wkv_reversed(r, k, v, w, u, s0):
    """``_wkv_chunk`` with y summed over k in reverse order."""
    def step(s, inp):
        rt, kt, vt, wt = inp
        at = kt[..., :, None] * vt[..., None, :]
        bonus = (u[None] * kt)[..., :, None] * vt[..., None, :]
        y = jnp.einsum("bhk,bhkv->bhv", rt[..., ::-1],
                       (s + bonus)[..., ::-1, :])
        s = wt[..., :, None] * s + at
        return s, y

    rs, ks_, vs, ws = (t.transpose(1, 0, 2, 3) for t in (r, k, v, w))
    s_last, ys = jax.lax.scan(step, s0, (rs, ks_, vs, ws))
    return ys.transpose(1, 0, 2, 3), s_last


def _block(cfg, plan, wkv):
    """The reference's block at one token from a zero state, jitted with
    ``_wkv_chunk`` replaced by ``wkv`` while it traces."""
    fn = jax.jit(lambda lp, x: TR.block_forward(x, lp, None, cfg, plan,
                                                want_cache=False)[0])

    def run(lp, x):
        S._wkv_chunk = wkv
        try:
            return fn(lp, x)
        finally:
            S._wkv_chunk = _ORIG
    return run


def _head_rms_y(lp, x, cfg, plan):
    """Per (lane, head) rms of layer 0's WKV output y = c v."""
    h = TR._norm(x, lp["norm1"], cfg)
    B, _, d = h.shape
    mixed = S._rwkv_mix(lp["tmix"], h, jnp.zeros((B, 1, d), h.dtype))
    p = lp["tmix"]
    r, k, v = (jnp.einsum("bsd,dhk->bshk", mixed[:, :, i], p[n])
               for i, n in ((0, "w_r"), (1, "w_k"), (2, "w_v")))
    c = jnp.einsum("bshk,hk->bsh", r * k, p["u_bonus"])[:, 0]
    return np.asarray(jnp.abs(c) * jnp.sqrt(jnp.mean(v[:, 0] ** 2, -1)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--layers", type=int, default=None,
                    help="default: rwkv6-3b's 32")
    args = ap.parse_args(argv)
    cfg = get_config("rwkv6-3b")
    n_layers = args.layers or cfg.num_layers
    plan = local_plan(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(args.seed), n_layers + 2)
    x0 = L.embed_init(keys[0], (args.lanes, 1, cfg.d_model))
    blocks = (_block(cfg, plan, _ORIG), _block(cfg, plan, _wkv_reversed))
    xs = [x0, x0]
    print(f"rwkv6-3b blocks at full width, one step from a zero state, "
          f"{args.lanes} lanes, f32, seed {args.seed}")
    per_layer = []
    for i in range(n_layers):
        lp = TR.init_layer(keys[i + 1], cfg, plan)
        if i == 0:
            rms_y = _head_rms_y(lp, x0, cfg, plan)
            print(f"  layer 0 per-head rms(y) = |c| rms(v): min "
                  f"{rms_y.min():.4e}, median {np.median(rms_y):.4e}, "
                  f"{int((rms_y < 1e-3).sum())} of {rms_y.size} below "
                  f"sqrt(eps) = 1e-3")
        xs = [blk(lp, x) for blk, x in zip(blocks, xs)]
        a, b = (np.asarray(x, np.float64) for x in xs)
        rel = float(np.abs(a - b).max() / np.abs(a).max())
        per_layer.append(rel)
        print(f"  after layer {i}: max |x| {np.abs(a).max():.4e}, max "
              f"|diff| {np.abs(a - b).max():.4e}, relative {rel:.4e}",
              flush=True)
        del lp
    norm = TR._norm_init(cfg, jnp.float32)
    unembed = L.dense_init(keys[-1], (cfg.d_model, cfg.vocab_size))
    logits = [np.asarray(TR._norm(x, norm, cfg)[:, 0] @ unembed, np.float64)
              for x in xs]
    d_logit = float(np.abs(logits[0] - logits[1]).max())
    same = int((logits[0].argmax(-1) == logits[1].argmax(-1)).sum())
    print(f"  logits: max |logit| {np.abs(logits[0]).max():.4e}, max |diff| "
          f"{d_logit:.4e}, argmax equal {same} of {args.lanes}")
    return {"per_layer_rel": per_layer, "logit_diff": d_logit,
            "argmax_same": same, "head_rms_y_min": float(rms_y.min())}


if __name__ == "__main__":
    main()
