"""``torch.library.opcheck`` over every kernel op of ``kernels.ops`` at
small shapes, on the CPU (the plain versions) or on a card (the kernels).

    PYTHONPATH=src python -m repro_torch.kernels.opcheck
    PYTHONPATH=src python -m repro_torch.kernels.opcheck --device cuda

Each case holds its op's fake against the implementation of its device
(shapes, dtypes, strides, aliasing), its schema against what the
implementation reads and writes (kernel 7's ``s_out``, also when it is
``s0``, the slot pool's case), and its eager result against an
AOT-dispatched one with dynamic shapes.  The cases cover kernel 1's
causal, window and bidirectional forms, its training forward and
backward, kernels 2-5 (kernel 2 also with a pinned plan, kernel 5 over
a ring), kernel 7's serve form with and without a state, its training
form and backward, and kernel 6 in bf16 and f32 out.  Inputs are drawn
on the CPU from one seed and moved to the device, so both devices check
the same values.  Prints one line per case and exits non-zero on any
failure.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.kernels import ops  # noqa: F401  (registers the ops)

B, H, K, D = 2, 4, 2, 16       # lanes, query and KV heads, head dim
S = 40                         # kernel 1's and kernel 5's keys
BS, T, BLOCKS = 16, 4, 9       # the pool's block size, table width, blocks
C = 8                          # kernel 3's chunk
TW = 5                         # kernel 7's steps


def _rand(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen).to(dtype)


def _pool(gen, dtype):
    """A pool with lane 0 on blocks 1-4 and lane 1 on 5-8, and each
    lane's last position (lane 1's chunk in its last block)."""
    kp, vp = (_rand(gen, BLOCKS, BS, K, D, dtype=dtype) for _ in range(2))
    tables = torch.arange(1, 1 + B * T, dtype=torch.int32).reshape(B, T)
    return kp, vp, tables, torch.tensor([37, 50], dtype=torch.int32)


def _wkv(gen, dtype=torch.bfloat16):
    r, k, v = (_rand(gen, B, TW, H, D, dtype=dtype) for _ in range(3))
    w = torch.exp(-torch.exp(_rand(gen, B, TW, H, D) - 1.0))
    return r, k, v, w, 0.1 * _rand(gen, H, D), _rand(gen, B, H, D, D)


def _case(op: str, case: str, gen):
    """``(overload, args, kwargs)`` of one case, on the CPU."""
    bf, f32 = torch.bfloat16, torch.float32
    if op in ("flash_attention", "flash_attention_lse",
              "flash_attention_bwd"):
        dt = bf if op == "flash_attention" else f32
        q, k, v = (_rand(gen, B, n, S, D, dtype=dt) for n in (H, K, K))
        kw = {"causal": {"causal": True}, "window": {"window": 12},
              "bidirectional": {"causal": False}}[case]
        if op != "flash_attention_bwd":
            return "default", (q, k, v), kw
        o, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, **kw)
        return "default", (q, k, v, o, _rand(gen, B, H, S, D), lse), kw
    if op in ("paged_decode_attention", "paged_decode_attention_lse"):
        q = _rand(gen, B, H, D, dtype=bf)
        kp, vp, tables, pos = _pool(gen, bf)
        kw = {"plan_lanes": 1} if case == "pinned plan" else {}
        if op == "paged_decode_attention":
            return "default", (q, kp, vp, tables, pos), kw
        owned = torch.tensor([[1, 0, 1, 1], [0, 1, 1, 0]], dtype=torch.int32)
        return "default", (q, kp, vp, tables, pos, owned), kw
    if op in ("paged_prefill_attention", "paged_prefill_attention_lse",
              "paged_verify_attention"):
        q = _rand(gen, B, C, H, D, dtype=bf)
        kp, vp, tables, _ = _pool(gen, bf)
        starts = torch.tensor([0, 50], dtype=torch.int32)
        if op == "paged_prefill_attention_lse":
            owned = torch.tensor([[1, 1, 0, 1], [1, 0, 1, 1]],
                                 dtype=torch.int32)
            return "default", (q, kp, vp, tables, starts, owned), {}
        return "default", (q, kp, vp, tables, starts), {}
    if op == "decode_attention":
        q = _rand(gen, B, H, D, dtype=bf)
        k, v = (_rand(gen, B, S, K, D, dtype=bf) for _ in range(2))
        if case == "ring":
            return "default", (q, k, v, torch.tensor([S - 1, 17],
                                                     dtype=torch.int32)), \
                {"ring": True}
        return "default", (q, k, v, torch.tensor([S - 1, 5],
                                                 dtype=torch.int32)), {}
    if op == "rwkv6_wkv":
        r, k, v, w, u, s0 = _wkv(gen)
        if case == "fresh state":
            return "default", (r, k, v, w, u, None), {}
        if case == "from s0":
            return "default", (r, k, v, w, u, s0), {}
        s_out = s0 if case == "s_out is s0" else torch.zeros_like(s0)
        return "state_out", (r, k, v, w, u, s0, s_out), {}
    if op in ("rwkv6_wkv_train", "rwkv6_wkv_bwd"):
        r, k, v, w, u, s0 = _wkv(gen, f32)
        if op == "rwkv6_wkv_train":
            return "default", (r, k, v, w, u, s0), {}
        _, _, ckpt = torch.ops.repro_torch.rwkv6_wkv_train(r, k, v, w, u, s0)
        return "default", (r, k, v, w, u, ckpt, _rand(gen, B, TW, H, D),
                           _rand(gen, B, H, D, D)), {}
    out = {"bf16 out": bf, "f32 out": f32}[case]
    x, w = _rand(gen, 24, 64), _rand(gen, 64, 40)
    if op == "int8_matmul_quantized":
        return "default", (x, w), {"out_dtype": out}
    (x_q, sx), (w_q, sw) = ops.quantize_rows(x), ops.quantize_cols(w)
    return "default", (x_q, w_q, sx, sw), {"out_dtype": out}


# (op, case): every op at least once
CASES = (
    ("flash_attention", "causal"), ("flash_attention", "window"),
    ("flash_attention", "bidirectional"),
    ("flash_attention_lse", "causal"), ("flash_attention_lse", "window"),
    ("flash_attention_bwd", "causal"),
    ("flash_attention_bwd", "bidirectional"),
    ("paged_decode_attention", "plan"),
    ("paged_decode_attention", "pinned plan"),
    ("paged_decode_attention_lse", "stripe"),
    ("paged_prefill_attention", "chunk"),
    ("paged_prefill_attention_lse", "stripe"),
    ("paged_verify_attention", "verify"),
    ("decode_attention", "slots"), ("decode_attention", "ring"),
    ("rwkv6_wkv", "fresh state"), ("rwkv6_wkv", "from s0"),
    ("rwkv6_wkv", "s_out is s0"), ("rwkv6_wkv", "s_out apart"),
    ("rwkv6_wkv_train", "from s0"), ("rwkv6_wkv_bwd", "with ds"),
    ("int8_matmul", "bf16 out"), ("int8_matmul", "f32 out"),
    ("int8_matmul_quantized", "bf16 out"),
    ("int8_matmul_quantized", "f32 out"),
)


def inputs(op: str, case: str, device="cpu", seed: int = 0):
    """``(op overload, args, kwargs)`` of case ``(op, case)`` on
    ``device``: drawn on the CPU from ``seed``, then moved, an aliased
    ``s_out`` kept aliased."""
    overload, args, kwargs = _case(op, case, torch.Generator().manual_seed(
        seed))
    moved = {}
    args = tuple(moved.setdefault(id(a), a.to(device))
                 if isinstance(a, torch.Tensor) else a for a in args)
    return getattr(getattr(torch.ops.repro_torch, op), overload), args, \
        kwargs


def check(op: str, case: str, device="cpu", seed: int = 0) -> dict:
    """``torch.library.opcheck`` of one case: ``{test: "SUCCESS" or the
    exception}``."""
    fn, args, kwargs = inputs(op, case, device, seed)
    return torch.library.opcheck(fn, args, kwargs, raise_exception=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    failed = 0
    for op, case in CASES:
        res = check(op, case, args.device, args.seed)
        bad = {k: v for k, v in res.items() if v != "SUCCESS"}
        failed += bool(bad)
        print(f"opcheck {op} [{case}] on {args.device}: "
              + ("ok" if not bad else "; ".join(f"{k}: {v}"
                                                for k, v in bad.items())),
              flush=True)
    print(f"opcheck: {len(CASES) - failed} of {len(CASES)} cases pass")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
