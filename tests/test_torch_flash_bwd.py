"""Kernel 1's gradient on the CPU: ``ops.FlashAttentionFn`` (the plain
training forward and ``flash_attention_bwd_ref``, the Function the card
runs with the kernels) against ``jax.vjp`` of the reference oracle
``repro/kernels/ref.py::flash_attention_ref``, and
``flash_attention_bwd_ref`` against ``torch.autograd.grad`` of
``flash_attention_ref`` (in f32, where its rounding of dS to q's dtype is
the identity) and, in bf16, against its own formulas with that rounding;
the guard that keeps every kernel wrapper from
cutting a gradient.

Inputs from numpy seeds, in f32.  Tolerances, fixed before any result was
read: the Function's dq, dk and dv within 1e-5 of the reference's max
|grad| (the two sum in other orders); ``flash_attention_bwd_ref`` within
1e-6 of autograd's (the same f32 products, delta taken as rowsum(dO O)
where autograd takes rowsum(P dP))."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_cuda_route import cuda_route  # noqa: E402

# (B, H, K, S, D, causal, window): causal, window (W = 16 and W >= S),
# bidirectional (with and without a window); GQA 4/2, 8/2, 25/5 and MHA;
# head dims 16, 64, 80 and 256; S never a multiple of a tile
CASES = [
    (2, 4, 2, 37, 16, True, 0),
    (1, 8, 2, 50, 64, True, 16),
    (1, 25, 5, 33, 80, True, 64),
    (2, 4, 4, 21, 256, False, 0),
    (1, 8, 2, 45, 64, False, 16),
    (1, 4, 2, 29, 80, True, 29),
    (1, 25, 5, 19, 16, False, 0),
    (1, 4, 4, 67, 64, True, 0),
]
IDS = [f"B{b}-H{h}-K{k}-S{s}-D{d}-{'causal' if c else 'bidir'}-W{w}"
       for b, h, k, s, d, c, w in CASES]


def _inputs(seed, B, H, K, S, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, K, S, D)).astype(np.float32)
    v = rng.standard_normal((B, K, S, D)).astype(np.float32)
    do = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, do


def _within(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("B,H,K,S,D,causal,window", CASES, ids=IDS)
def test_function_grads_match_jax_vjp(B, H, K, S, D, causal, window):
    q, k, v, do = _inputs(S + D, B, H, K, S, D)
    f = lambda q, k, v: jref.flash_attention_ref(  # noqa: E731
        q, k, v, causal=causal, window=window)
    want_o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert o.grad_fn is not None
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    _within(o.detach(), want_o, 1e-5)
    for g, w in zip(got, want):
        _within(g, w, 1e-5)


@pytest.mark.parametrize("B,H,K,S,D,causal,window", CASES, ids=IDS)
def test_bwd_ref_matches_autograd(B, H, K, S, D, causal, window):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(S, B, H, K, S, D))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(o, leaves, do)
    o2, lse = fa.flash_attention_lse_ref(q, k, v, causal=causal,
                                         window=window)
    assert torch.equal(o2, o.detach())
    got = fa.flash_attention_bwd_ref(q, k, v, o2, do, lse, causal=causal,
                                     window=window)
    for g, w in zip(got, want):
        _within(g, w, 1e-6)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 5)])
def test_bf16_bwd_ref_rounds_ds(causal, window):
    """In bf16 the plain backward rounds dS to bf16 before dq and dk, as
    the kernel's tensor-core products take bf16 operands: dq and dk by hand
    from the plain formulas with ``ds.to(bfloat16)`` equal it bit for bit,
    and without that rounding they differ."""
    B, H, K, S, D = 1, 4, 2, 40, 32
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(11, B, H, K, S, D))
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_lse_ref(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    scale = 1.0 / D ** 0.5
    ke = k.repeat_interleave(H // K, dim=1).float()
    ve = v.repeat_interleave(H // K, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), ke) * scale
    s = torch.where(fa._mask(S, causal, window, "cpu"), s, fa.NEG_INF)
    p = torch.exp(s - lse[..., None])
    delta = (do.float() * o.float()).sum(dim=-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do.float(), ve)
              - delta[..., None])

    def grads(d):
        gq = torch.einsum("bhqk,bhkd->bhqd", d, ke) * scale
        gk = torch.einsum("bhqk,bhqd->bhkd", d, q.float()) * scale
        return (gq.to(torch.bfloat16),
                gk.view(B, K, H // K, S, D).sum(dim=2).to(torch.bfloat16))

    want_q, want_k = grads(ds.to(torch.bfloat16).float())
    assert torch.equal(dq, want_q) and torch.equal(dk, want_k)
    raw_q, raw_k = grads(ds)
    assert not (torch.equal(dq, raw_q) and torch.equal(dk, raw_k))
    assert dv.dtype == torch.bfloat16


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
def test_lse_ref_is_logsumexp_of_scores(causal, window):
    """lse = log sum_k exp(q.k scale) over the keys each query sees."""
    q, k, v, _ = _inputs(3, 1, 4, 2, 23, 16)
    _, lse = fa.flash_attention_lse_ref(*map(torch.from_numpy, (q, k, v)),
                                        causal=causal, window=window)
    ke = np.repeat(k, 2, axis=1).astype(np.float64)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), ke) / 4.0
    qi, ki = np.arange(23)[:, None], np.arange(23)[None, :]
    seen = np.ones((23, 23), bool)
    if causal:
        seen &= ki <= qi
    if window:
        seen &= ki > qi - window
    s = np.where(seen, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)


def test_serve_form_takes_no_function():
    """Without a grad-requiring input the call is today's serve form: no
    grad_fn, no lse computed."""
    q, k, v, _ = _inputs(4, 1, 4, 2, 9, 16)
    before = fa.flash_attention_lse_ref.calls
    o = ops.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert o.grad_fn is None
    assert fa.flash_attention_lse_ref.calls == before
    with torch.no_grad():
        tq = torch.from_numpy(q).requires_grad_(True)
        o = ops.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v))
    assert o.grad_fn is None and fa.flash_attention_lse_ref.calls == before


def test_refuse_grad_guard():
    """Every kernel wrapper's guard: it raises, naming the kernel and the
    reason, when grad mode is on and an input requires grad, and passes
    under no_grad / inference_mode or when nothing requires grad.  Kernel
    7's raw wrappers still refuse (its training goes through
    ``ops.rwkv6_wkv``, which under autograd is ``WkvFn``)."""
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with pytest.raises(RuntimeError, match="decode_attention: this kernel "
                                           "has no backward.*no_grad"):
        build.refuse_grad("decode_attention", y, x)
    build.refuse_grad("decode_attention", y, None, y)
    with torch.no_grad():
        build.refuse_grad("decode_attention", x, y)
    with torch.inference_mode():
        build.refuse_grad("decode_attention", x)
    with pytest.raises(RuntimeError, match="ops.flash_attention"):
        build.refuse_grad("flash_attention", x,
                          hint="ops.flash_attention carries kernel 1's "
                               "backward")
    from repro_torch.kernels import rwkv6_wkv as wkv
    r = torch.ones(1, 2, 1, 16, requires_grad=True)
    args = (r, torch.ones(1, 2, 1, 16), torch.ones(1, 2, 1, 16),
            torch.full((1, 2, 1, 16), 0.5), torch.zeros(1, 16))
    for fn in (wkv.rwkv6_wkv, wkv.rwkv6_wkv_train):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)
    out, _ = ops.rwkv6_wkv(*args)
    assert type(out.grad_fn).__name__ == "WkvFnBackward"


class _Ctx:
    def save_for_backward(self, *t):
        self.saved_tensors = t


def test_function_sends_cuda_tensors_to_the_kernels(monkeypatch):
    """On CUDA tensors ``FlashAttentionFn`` calls the training forward and
    the backward kernel, never their plain versions: through the ops'
    CUDA implementations (the dispatcher's CUDA key, on CPU tensors)."""
    calls = []

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    fwd = (torch.zeros(1), torch.zeros(1))
    bwd = tuple(torch.zeros(1) for _ in range(3))
    monkeypatch.setattr(fa, "flash_attention_lse_ref", plain)
    monkeypatch.setattr(fa, "flash_attention_bwd_ref", plain)
    monkeypatch.setattr(fa, "flash_attention_lse",
                        lambda *a, **k: calls.append(("fwd", k)) or fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd",
                        lambda *a, **k: calls.append(("bwd", k)) or bwd)
    ctx = _Ctx()
    q, k, v = (torch.zeros(1) for _ in range(3))
    with cuda_route() as route:
        ops.FlashAttentionFn.forward(ctx, q, k, v, 0.5, False, 16)
        assert len(ctx.saved_tensors) == 5
        grads = ops.FlashAttentionFn.backward(ctx, torch.zeros(1))
    assert route.ops == ["flash_attention_lse", "flash_attention_bwd"]
    assert all(a is b for a, b in zip(grads, bwd))
    assert grads[3:] == (None, None, None)
    kw = dict(scale=0.5, causal=False, window=16)
    assert calls == [("fwd", kw), ("bwd", kw)]


def test_bwd_kernel_not_built_at_import():
    assert not fa._bwd_kernel.cache_info().currsize
    assert "flash_attention_bwd" in build.SOURCES
