"""The dry run and ``op_cost`` on the CPU: four full-width cells on the
meta device (nothing allocated, the state's bytes exact), the meta
build's bytes against a real CPU build of every assigned smoke config,
``op_cost``'s GEMM flops of a smoke decode step against 2 x matmul
parameters x tokens, each kernel call counted by its row's formula in
``analysis.roofline`` (and its meta stand-in shaped as its plain
version's output), and, as a reading, a step's count beside the JAX
reference's ``analyze_hlo`` of the same step."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
import torch

from repro_torch.analysis import op_cost
from repro_torch.analysis import roofline as R
from repro_torch.configs import ASSIGNED, SHAPES, Shape, get_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import build_model, local_plan
from repro_torch.models.layers import tree_leaves

CELLS = [("llama2-7b", "decode_32k"), ("granite-moe-3b-a800m", "train_4k"),
         ("rwkv6-3b", "prefill_32k"), ("hubert-xlarge", "train_4k")]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_cell_on_the_meta_device(arch, shape):
    cfg, s = get_config(arch), SHAPES[shape]
    row = dryrun.run_cell(arch, shape)
    train = s.kind == "train"
    p_el = 4 if train else 2
    # every parameter once; AdamW's two f32 moments and its int32 step
    n_params = row["param_bytes"] // p_el
    assert n_params >= cfg.param_count()
    assert row["opt_bytes"] == (8 * n_params + 4 if train else 0)
    if s.kind == "decode":
        hd, K, L = cfg.head_dim, cfg.n_kv_heads, cfg.num_layers
        assert row["kv_bytes"] == 2 * L * s.global_batch * s.seq_len * K \
            * hd * 2
        assert row["kernels"]["decode_attention"]["calls"] == L
    else:
        assert row["kv_bytes"] == 0
    if train:
        assert row["grad_accum"] == dryrun.choose_grad_accum(cfg, s, 1)
    else:
        assert "grad_accum" not in row
    assert row["peak_live_bytes"] >= row["param_bytes"] + row["opt_bytes"] \
        + row["kv_bytes"]
    assert row["fits"] == (row["peak_live_bytes"] <= R.HW.hbm_bytes)
    assert row["model_flops"] == R.model_flops(
        cfg.param_count(active=True), s.kind, row["tokens"])
    assert row["hlo_flops_total"] == row["flops"] >= row["gemm_flops"] > 0
    assert row["t_compute_s"] == row["flops"] / R.HW.peak_flops_bf16
    assert row["t_memory_s"] == row["bytes"] / R.HW.hbm_bw
    assert row["t_collective_s"] == 0.0 and row["chips"] == 1
    kernels = {"decode_32k": {"decode_attention"},
               "prefill_32k": {"rwkv6_wkv"}}.get(
        shape, {"flash_attention_lse", "flash_attention_bwd"})
    assert set(row["kernels"]) == kernels


def test_sweep_rows_skips_and_errors(capsys):
    rows = list(dryrun.sweep(["hubert-xlarge"], ["decode_32k", "long_500k"]))
    assert [(r["arch"], r["shape"], "skipped" in r) for r in rows] == [
        ("hubert-xlarge", "decode_32k", True),
        ("hubert-xlarge", "long_500k", True)]
    bad = list(dryrun.sweep(["llama2-7b"], ["no_such_shape"]))
    assert len(bad) == 1 and "KeyError" in bad[0]["error"]
    assert dryrun.main(["--arch", "llama2-7b", "--shape",
                        "no_such_shape"]) == 1
    assert "1 FAILURES" in capsys.readouterr().err


def test_allocator_span_rounds_each_storage():
    from repro_torch.analysis.oncard import ALLOC_ROUND, ALLOC_TAIL, \
        allocator_span
    small = torch.zeros(250)                       # 1000 B
    big = torch.zeros(ALLOC_TAIL // 4 * 3 + 1)     # 3 MiB + 4 B
    tree = {"a": torch.zeros(1), "b": [small, small[1:]], "c": big,
            "m": torch.empty(10, device="meta")}
    lo, hi = allocator_span(tree)
    assert lo == ALLOC_ROUND + 2 * ALLOC_ROUND + 3 * ALLOC_TAIL \
        + ALLOC_ROUND + ALLOC_ROUND
    assert hi == lo + ALLOC_TAIL
    assert allocator_span([]) == (0, 0)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_meta_state_bytes_equal_a_real_cpu_build(arch):
    cfg = get_config(arch).smoke_config()
    shapes = [Shape("t", "train", 32, 2), Shape("p", "prefill", 32, 2)]
    if "decode_32k" not in cfg.skip_shapes:
        shapes.append(Shape("d", "decode", 48, 3))
    for s in shapes:
        meta = dryrun.cell_state(cfg, s, device="meta")
        real = dryrun.cell_state(cfg, s, device="cpu")
        assert all(t.is_meta for t in tree_leaves(meta[1:]) if t is not None)
        for a, b in zip(meta[1:], real[1:]):
            assert (a is None) == (b is None)
            if a is not None:
                assert [(t.shape, t.dtype) for t in tree_leaves(a)] == \
                    [(t.shape, t.dtype) for t in tree_leaves(b)]
                assert _nbytes(a) == _nbytes(b) > 0


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-1.7b"])
def test_decode_step_gemm_flops_are_2_x_matmul_params_x_tokens(arch):
    cfg = get_config(arch).smoke_config()
    model = build_model(cfg, local_plan(param_dtype=torch.bfloat16),
                        device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_paged_cache(25, 8)
    B = 3
    tok = torch.tensor([5, 9, 11], dtype=torch.int32)
    pos = torch.tensor([4, 17, 30], dtype=torch.int32)
    tab = torch.arange(24, dtype=torch.int32).reshape(B, 8) + 1
    with torch.inference_mode():
        _, cost = op_cost.count(model.decode_step_paged, params, cache, tok,
                                pos, tab, live=(params, cache),
                                breakdown=True)
    layers = params["layers"]
    mats = sum(t.numel() for part in ("attn", "mlp")
               for name, t in layers[part].items() if t.dim() >= 3)
    mats += cfg.vocab_size * cfg.d_model          # the head (tied or not)
    assert cost["gemm_flops"] == 2 * mats * B
    # kernel 2 once per layer, counted at the live keys of these positions
    k2 = cost["kernels"]["paged_decode_attention"]
    keys = int((pos + 1).sum())
    assert k2["calls"] == cfg.num_layers
    assert k2["flops"] == cfg.num_layers * 4 * cfg.head_dim * cfg.n_heads \
        * keys
    assert cost["census"]["kernel:paged_decode_attention"] == cfg.num_layers
    assert cost["peak_live_bytes"] >= _nbytes((params, cache))
    # the breakdown: every layer's count the same, the head outside them
    per = cost["breakdown"]
    layers = [per[f"layer {i}"] for i in range(cfg.num_layers)]
    assert all(row == layers[0] for row in layers)
    assert sum(r["flops"] for r in per.values()) == cost["flops"]
    assert per["other"]["flops"] >= 2 * cfg.vocab_size * cfg.d_model * B


def _rand(*shape, dtype=torch.float32, gen):
    return torch.randn(*shape, generator=gen).to(dtype)


def _calls(gen):
    """(kernel name, ops function, args, kwargs, formula) on the CPU: the
    formula's bytes and flops worked out from the inputs by hand."""
    bf = torch.bfloat16
    B, H, K, S, D, bs, T = 2, 4, 2, 12, 16, 4, 5
    q, k, v = (_rand(B, n, S, D, dtype=bf, gen=gen) for n in (H, K, K))
    qd = _rand(B, H, D, dtype=bf, gen=gen)
    pool = _rand(11, bs, K, D, dtype=bf, gen=gen)
    tab = torch.tensor([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], dtype=torch.int32)
    pos = torch.tensor([6, 17], dtype=torch.int32)
    owned = torch.tensor([[1, 0, 1, 0, 0], [1, 1, 0, 0, 1]],
                         dtype=torch.int32)
    C = 3
    qc = _rand(B, C, H, D, dtype=bf, gen=gen)
    starts = torch.tensor([0, 9], dtype=torch.int32)
    cache = _rand(B, S, K, D, dtype=bf, gen=gen)
    Tw = 7
    r = _rand(B, Tw, H, D, dtype=bf, gen=gen)
    w = torch.rand(B, Tw, H, D, generator=gen) * 0.5 + 0.4
    u = _rand(H, D, gen=gen)
    s0 = _rand(B, H, D, D, gen=gen)
    x, wm = _rand(5, 32, gen=gen), _rand(32, 24, gen=gen)
    keys = 7 + 18
    pairs = lambda s0s: sum(C * a + C * (C + 1) // 2 for a in s0s)  # noqa
    # owned keys at or before pos: lane 0 keys 0-3 (block 0; pos 6 stops
    # in block 1, unowned), lane 1 keys 0-7 and 16-17 (blocks 0, 1, 4)
    own_keys = 4 + 10
    return [
        ("flash_attention", ops.flash_attention, (q, k, v), {},
         (2 * B * S * (H + K) * D * 2, 4 * D * B * H * S * (S + 1) // 2)),
        ("flash_attention", ops.flash_attention, (q, k, v),
         {"causal": False, "window": 5},
         (2 * B * S * (H + K) * D * 2, 4 * D * B * H * R.attn_pairs(S, False,
                                                                    5))),
        ("paged_decode_attention", ops.paged_decode_attention,
         (qd, pool, pool, tab, pos), {},
         (2 * keys * K * D * 2 + 2 * B * H * D * 2 + 4 * (2 + 5) + 4 * B,
          4 * D * H * keys)),
        ("paged_decode_attention_lse", ops.paged_decode_attention_lse,
         (qd, pool, pool, tab, pos, owned), {},
         (2 * own_keys * K * D * 2 + 2 * B * H * D * 2 + 4 * B * H
          + 4 * (2 + 5 + 1 + 3 + B), 4 * D * H * own_keys)),
        ("paged_prefill_attention", ops.paged_prefill_attention,
         (qc, pool, pool, tab, starts), {},
         (2 * (3 + 12) * K * D * 2 + 2 * B * C * H * D * 2 + 4 * (1 + 3)
          + 4 * B, 4 * D * H * pairs([0, 9]))),
        ("paged_prefill_attention", ops.paged_verify_attention,
         (qc, pool, pool, tab, starts), {},
         (2 * (3 + 12) * K * D * 2 + 2 * B * C * H * D * 2 + 4 * (1 + 3)
          + 4 * B, 4 * D * H * pairs([0, 9]))),
        # lane 0's queries 0-2 see keys 0-2 (owned block 0): 6 pairs;
        # lane 1's queries 9-11 see keys 0-11, 8 of them owned: 24 pairs
        ("paged_prefill_attention_lse", ops.paged_prefill_attention_lse,
         (qc, pool, pool, tab, starts, owned), {},
         (2 * (3 + 8) * K * D * 2 + 2 * B * C * H * D * 2 + 4 * B * C * H
          + 8 * (1 + 3) + 4 * B, 4 * D * H * (6 + 3 * 8))),
        ("decode_attention", ops.decode_attention,
         (qd, cache, cache, torch.tensor([3, 11], dtype=torch.int32)), {},
         (2 * 16 * K * D * 2 + 2 * B * H * D * 2 + 4 * B, 4 * D * H * 16)),
        ("rwkv6_wkv", ops.rwkv6_wkv, (r, r, r, w, u, s0), {},
         R.wkv_work(B, Tw, H, D, bf, state_in=True)[:2]),
        ("int8_matmul_quantized", ops.int8_matmul_quantized, (x, wm), {},
         (5 * 32 + 32 * 24 + 4 * (5 + 24) + 2 * 5 * 24, 2 * 5 * 24 * 32)),
    ]


def test_each_kernel_call_counts_as_its_formula():
    gen = torch.Generator().manual_seed(3)
    for name, fn, args, kwargs, (n_bytes, flops) in _calls(gen):
        with torch.no_grad():
            out, cost = op_cost.count(fn, *args, **kwargs)
        assert cost["kernels"] == {name: {"calls": 1, "flops": flops,
                                          "bytes": n_bytes}}, name
        # nothing the plain version did is counted: one op, the call
        assert cost["census"] == {f"kernel:{name}": 1}, name
        assert (cost["flops"], cost["bytes"]) == (flops, n_bytes), name
        # on the meta device the call's stand-in has the plain output's
        # shapes and dtypes
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        with torch.no_grad():
            stand_in, mcost = op_cost.count(fn, *meta, **kwargs)
        got, want = (list(op_cost._tensors(t)) for t in (stand_in, out))
        assert [(t.shape, t.dtype) for t in got] == \
            [(t.shape, t.dtype) for t in want], name
        assert all(t.is_meta for t in got)
        assert mcost["kernels"][name]["flops"] >= flops


def test_training_kernels_count_as_their_formulas():
    """Kernel 1's and kernel 7's training forms and backward kernels,
    reached through autograd (``FlashAttentionFn``, ``WkvFn``)."""
    from repro_torch.kernels.rwkv6_wkv import wkv_chunk
    gen = torch.Generator().manual_seed(4)
    B, H, K, S, D = 2, 4, 2, 10, 16
    q, k, v = (_rand(B, n, S, D, gen=gen).requires_grad_(True)
               for n in (H, K, K))
    _, cost = op_cost.count(lambda: ops.flash_attention(q, k, v).sum()
                            .backward())
    kern = cost["kernels"]
    assert kern["flash_attention_lse"]["flops"] == R.flash_attention_work(
        B, H, K, S, D, torch.float32, lse=True)[1]
    assert kern["flash_attention_bwd"] == dict(zip(
        ("bytes", "flops"), R.flash_attention_bwd_work(
            B, H, K, S, D, torch.float32)[:2]), calls=1)
    T = 40
    r, kk, vv = (_rand(B, T, H, D, gen=gen).requires_grad_(True)
                 for _ in range(3))
    w = (torch.rand(B, T, H, D, generator=gen) * 0.5 + 0.4)
    u = _rand(H, D, gen=gen).requires_grad_(True)
    _, cost = op_cost.count(lambda: ops.rwkv6_wkv(r, kk, vv, w, u)[0].sum()
                            .backward())
    n_ck = -(-T // wkv_chunk(D))
    assert cost["kernels"]["rwkv6_wkv_train"]["bytes"] == R.wkv_train_work(
        B, T, H, D, torch.float32, n_ck)[0]
    assert cost["kernels"]["rwkv6_wkv_bwd"]["flops"] == R.wkv_bwd_work(
        B, T, H, D, torch.float32, n_ck, ds_in=False)[1]


def test_step_count_beside_the_reference_hlo_count():
    """A reading, not a check: the smoke decode step's flops and bytes as
    ``op_cost`` counts them and as the reference's ``analyze_hlo`` counts
    its compiled step (its attention in XLA, not a kernel)."""
    jax = pytest.importorskip("jax")
    from repro.analysis.hlo_cost import analyze_hlo
    from repro.analysis.iraudit.registry import (AuditContext as JCtx,
                                                 ENTRYPOINTS_BY_NAME,
                                                 audit_entry)
    jaudit = audit_entry(ENTRYPOINTS_BY_NAME["decode_step_paged"], JCtx())
    want = analyze_hlo(jaudit.hlo)
    from repro_torch.analysis.iraudit import AuditContext, audit_entry as ae
    from repro_torch.analysis.iraudit import ENTRYPOINTS_BY_NAME as PORT
    got = ae(PORT["decode_step_paged"],
             AuditContext(device="cpu")).trace.cost
    print(f"decode_step_paged at smoke geometry (jax {jax.__version__}): "
          f"op_cost {got['flops']} flop, {got['bytes']} B (GEMMs "
          f"{got['gemm_flops']}, kernels {got['kernel_flops']}); "
          f"analyze_hlo {want['flops']:.0f} flop, {want['bytes']:.0f} B")
    assert got["flops"] > 0 and want["flops"] > 0
