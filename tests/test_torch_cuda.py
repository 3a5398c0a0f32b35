"""The CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips (with the reason) where there is no CUDA
device or no ``nvcc``; run them on a GPU machine with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The module imports no JAX, so it runs where only PyTorch is installed.
Tolerances: f32 at 1e-4 (sums in another order than the plain version),
bf16 at 2e-2 (rounding of P and of the output to bf16); besides, the
error's norm over the plain output's norm stays below 1e-5 (f32) or 1e-2
(bf16), a bound that scales with outputs that shrink at long contexts."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pa
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.models import build_model, local_plan

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def assert_close(got, want, dtype):
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=0)
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    assert rel <= REL_TOL[dtype], f"relative error {rel:.3e}"


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,D", [
    (2, 8, 2, 64, 64), (1, 4, 4, 200, 128), (3, 4, 1, 37, 32),
    (2, 32, 32, 513, 128), (2, 4, 2, 24, 16),
])
def test_flash_kernel_matches_plain(gen, dtype, B, H, K, S, D):
    q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=dtype)
    k = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=dtype)
    v = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=dtype)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    before = fa.flash_attention.launches
    o = fa.flash_attention(*args)
    assert fa.flash_attention.launches == before + 1
    assert o.stride() == args[0].stride()          # output keeps q's layout
    assert_close(o, fa.flash_attention_ref(*args), dtype)


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,H,K,D,bs,T", [
    (2, 8, 2, 64, 16, 8), (1, 4, 4, 128, 32, 4), (3, 4, 1, 64, 16, 8),
    (2, 64, 8, 128, 16, 20), (4, 8, 8, 32, 8, 6),
])
def test_paged_decode_kernel_matches_plain(gen, q_dt, kv_dt, B, H, K, D, bs, T):
    n_blocks = 1 + B * T
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    pos = torch.randint(0, T * bs, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    q = torch.randn(B, H, D, generator=gen, device="cuda", dtype=q_dt)
    kp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    vp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    o = ops.paged_decode_attention(q, kp, vp, tables, pos)
    ref = pa.paged_decode_attention_ref(q, kp, vp, tables, pos)
    assert_close(o, ref, max(q_dt, kv_dt, key=TOL.get))


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,C,H,K,D,bs,T", [
    (2, 16, 8, 2, 64, 16, 8), (3, 8, 4, 4, 128, 32, 4),
    (2, 5, 4, 1, 32, 8, 10), (2, 128, 32, 32, 128, 16, 24),
    (2, 16, 64, 8, 128, 16, 20), (1, 24, 4, 2, 16, 8, 6),
])
def test_paged_prefill_kernel_matches_plain(gen, q_dt, kv_dt, B, C, H, K, D,
                                            bs, T):
    """Scrambled tables, one start at 0 and one mid-table, and a padded
    lane (table of zeros, start 0) reading only the parking block."""
    n_blocks = 1 + B * T
    tables = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
              + 1)[: B * T].reshape(B, T).to(torch.int32)
    starts = torch.randint(0, T * bs - C + 1, (B,), generator=gen,
                           device="cuda", dtype=torch.int32)
    starts[0] = 0
    if B > 2:
        tables[-1] = 0
        starts[-1] = 0
    q = torch.randn(B, C, H, D, generator=gen, device="cuda", dtype=q_dt)
    kp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    vp = torch.randn(n_blocks, bs, K, D, generator=gen, device="cuda",
                     dtype=kv_dt)
    before = ppa.paged_prefill_attention.launches
    o = ops.paged_prefill_attention(q, kp, vp, tables, starts)
    assert ppa.paged_prefill_attention.launches == before + 1
    ref = ppa.paged_prefill_attention_ref(q, kp, vp, tables, starts)
    assert_close(o, ref, max(q_dt, kv_dt, key=TOL.get))
    v = ops.paged_verify_attention(q, kp, vp, tables, starts)
    assert ppa.paged_prefill_attention.launches == before + 2
    assert torch.equal(o, v)


@pytest.mark.parametrize("q_dt,kv_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("B,H,K,D,S", [
    (2, 8, 2, 64, 64), (1, 4, 4, 128, 100), (3, 4, 1, 32, 37),
    (4, 32, 32, 128, 2048), (2, 64, 8, 128, 1000), (2, 4, 2, 16, 24),
])
def test_decode_kernel_matches_plain(gen, q_dt, kv_dt, B, H, K, D, S):
    """Contiguous cache, S not always a multiple of the key tile, one lane
    at the last position and one parked at 0; held against the plain
    version of the slot model path (``flash_decode_ref``, what the
    dispatcher takes on the CPU) and against the oracle."""
    pos = torch.randint(0, S, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[0] = S - 1
    if B > 1:
        pos[-1] = 0
    q = torch.randn(B, H, D, generator=gen, device="cuda", dtype=q_dt)
    k = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=kv_dt)
    v = torch.randn(B, S, K, D, generator=gen, device="cuda", dtype=kv_dt)
    before = da.decode_attention.launches
    o = ops.decode_attention(q, k, v, pos)
    assert da.decode_attention.launches == before + 1
    dt = max(q_dt, kv_dt, key=TOL.get)
    assert_close(o, da.flash_decode_ref(q, k, v, pos), dt)
    assert_close(o, da.decode_attention_ref(q, k, v, pos), dt)


def test_kernel_wrappers_raise_on_bad_input(gen):
    q = torch.zeros(1, 2, 16, 48, device="cuda")          # head dim 48
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    pool = torch.zeros(3, 8, 2, 32, device="cuda")
    tab = torch.zeros(1, 2, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError):
        pa.paged_decode_attention(torch.zeros(1, 2, 32, device="cuda"), pool,
                                  pool, tab,
                                  torch.zeros(1, dtype=torch.int32,
                                              device="cuda"))
    with pytest.raises(ValueError):                      # head dim 48
        ppa.paged_prefill_attention(torch.zeros(1, 4, 2, 48, device="cuda"),
                                    torch.zeros(3, 8, 2, 48, device="cuda"),
                                    torch.zeros(3, 8, 2, 48, device="cuda"),
                                    tab.int(), torch.zeros(1, dtype=torch.int32,
                                                           device="cuda"))
    with pytest.raises(ValueError):                      # H not a multiple of K
        da.decode_attention(torch.zeros(1, 3, 32, device="cuda"),
                            torch.zeros(1, 8, 2, 32, device="cuda"),
                            torch.zeros(1, 8, 2, 32, device="cuda"),
                            torch.zeros(1, dtype=torch.int32, device="cuda"))


def test_smoke_model_kernel_path_matches_plain_path(gen):
    """A smoke-size model's prefill logits through the kernels vs through
    the plain versions, both on the card, at f32."""
    cfg = get_config("llama2-7b").smoke_config()
    m = build_model(cfg, local_plan(param_dtype=torch.float32,
                                    compute_dtype=torch.float32))
    p = m.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (3, 32), generator=gen,
                           device="cuda", dtype=torch.int32)
    lengths = torch.tensor([32, 7, 20], dtype=torch.int32, device="cuda")
    lk, _ = m.prefill_ragged(p, tokens, lengths)
    saved = ops.flash_attention
    ops.flash_attention = fa.flash_attention_ref
    try:
        lp, _ = m.prefill_ragged(p, tokens, lengths)
    finally:
        ops.flash_attention = saved
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)


def test_smoke_model_chunk_and_slot_paths_match_plain_path(gen):
    """A smoke-size model's chunked-prefill logits (kernel 3) and slot
    decode logits (kernel 5) through the kernels vs through the plain
    versions, both on the card, all in f32."""
    cfg = get_config("llama2-7b").smoke_config()
    m = build_model(cfg, local_plan(param_dtype=torch.float32,
                                    compute_dtype=torch.float32))
    p = m.init(torch.Generator(device="cuda").manual_seed(0))
    B, C, bs, T = 3, 16, 8, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=gen,
                           device="cuda", dtype=torch.int32)
    starts = torch.tensor([0, 16, 40], dtype=torch.int32, device="cuda")
    lengths = torch.tensor([16, 5, 16], dtype=torch.int32, device="cuda")
    tables = (1 + torch.arange(B * T, device="cuda", dtype=torch.int32)
              ).reshape(B, T)
    pool = m.init_paged_cache(1 + B * T, bs, dtype=torch.float32)
    for leaf in pool["attn"].values():
        leaf.normal_(generator=gen)
    cache = m.init_cache(B, 64, dtype=torch.float32)
    for leaf in cache["attn"].values():
        leaf.normal_(generator=gen)
    pos = torch.tensor([63, 0, 30], dtype=torch.int32, device="cuda")
    pool2 = {"attn": {n: t.clone() for n, t in pool["attn"].items()}}
    cache2 = {"attn": {n: t.clone() for n, t in cache["attn"].items()}}
    lk, _ = m.prefill_chunk_paged(p, pool, tokens, starts, lengths, tables)
    dk, _ = m.decode_step(p, cache, tokens[:, 0].contiguous(), pos)
    saved = ops.paged_prefill_attention, ops.decode_attention
    ops.paged_prefill_attention = ppa.paged_prefill_attention_ref
    ops.decode_attention = da.flash_decode_ref
    try:
        lp, _ = m.prefill_chunk_paged(p, pool2, tokens, starts, lengths,
                                      tables)
        dp, _ = m.decode_step(p, cache2, tokens[:, 0].contiguous(), pos)
    finally:
        ops.paged_prefill_attention, ops.decode_attention = saved
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=0)
    torch.testing.assert_close(dk, dp, atol=1e-4, rtol=0)
    # the same rows written; from layer 1 on their values carry the
    # attention outputs' rounding differences
    for n in ("k", "v"):
        torch.testing.assert_close(pool["attn"][n][:, 1:],
                                   pool2["attn"][n][:, 1:], atol=1e-4, rtol=0)
        torch.testing.assert_close(cache["attn"][n], cache2["attn"][n],
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", [[], ["--no-paged"]])
def test_serve_cli_modes_on_cuda_match_cpu(gen, mode):
    """The paged and slot serve CLI on the card print the same dict as on
    the CPU (no eos in its workload, so the counters do not depend on the
    weights)."""
    from repro_torch.launch import serve
    assert serve.main(["--smoke", *mode]) == \
        serve.main(["--smoke", *mode, "--device", "cpu"])


def test_serve_cli_on_cuda_matches_cpu(gen):
    """The serve CLI's default device runs both kernels and prints the
    same counters as its CPU run (serve's workload has no eos, so they do
    not depend on the weights)."""
    from repro_torch.launch import serve
    fa.flash_attention.launches = pa.paged_decode_attention.launches = 0
    got = serve.main(["--smoke"])
    assert fa.flash_attention.launches > 0
    assert pa.paged_decode_attention.launches > 0
    assert got == serve.main(["--smoke", "--device", "cpu"])
