"""Kernel 7's gradient and the Mamba scan's on the CPU.

Kernel 7: the plain training form (``rwkv6_wkv_train_ref``: y bit for bit
``rwkv6_wkv_ref``'s, the checkpoints the states before every C-th step)
and the plain backward (``rwkv6_wkv_bwd_ref``, the kernel's reverse loop)
against ``jax.vjp`` of the reference oracle ``kernels/ref.py::
rwkv6_wkv_ref`` in f32 at head dims 16 and 64, T ragged (not a multiple
of C), s0 zero and random, dS_T zero and random, within 1e-5 of each
gradient's max |g| (the same sums in other orders over up to 300 steps);
against ``torch.autograd`` of the plain forward (1e-5); the kernel's
partition of the rows over its cluster (``rwkv6_wkv_bwd_split_ref``) at
every head dim (1e-6 of the plain backward, 1e-5 of ``jax.vjp``); ``ops.WkvFn`` on
CPU tensors (its saved tensors and checkpoints), sending CUDA tensors to
the kernels only.

The Mamba scan: ``ssm.SelectiveScanFn``'s forward bit for bit the serve
path's ``_selective_scan``; its backward against ``torch.autograd`` of an
out-of-place scan (f64, 1e-12) and against ``jax.vjp`` of the reference's
chunked scan (``models/ssm.py``'s ``_selective_scan_chunk`` carried over
chunks, as ``mamba_forward`` runs it; f32, 1e-5 of each gradient's max
|g|)."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ref import rwkv6_wkv_ref as j_wkv_ref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_cuda_route import cuda_route  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402


def _wkv_inputs(rng, B, T, H, D):
    r, k, v, dy = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                   for _ in range(4))
    # rwkv6-3b's decay near its init (dw = -6 + N(0, 1)) and faster ones
    w = np.exp(-np.exp(rng.uniform(-6.0, 0.5, (B, T, H, D)))).astype(
        np.float32)
    u = (0.1 * rng.standard_normal((H, D))).astype(np.float32)
    return r, k, v, w, u, dy


def _held(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err,
                                                        np.abs(want).max())


def test_wkv_chunk_per_head_dim():
    assert [wkv.wkv_chunk(d) for d in wkv.HEAD_DIMS] == [128, 64, 32, 32,
                                                          16, 16, 16, 16]


@pytest.mark.parametrize("D,T", [(16, 37), (16, 300), (64, 70)])
def test_train_form_keeps_y_and_checkpoints(D, T):
    rng = np.random.default_rng(D + T)
    r, k, v, w, u, _ = map(torch.from_numpy, _wkv_inputs(rng, 2, T, 3, D))
    s0 = torch.from_numpy(rng.standard_normal((2, 3, D, D)).astype(
        np.float32))
    y, s, ck = wkv.rwkv6_wkv_train_ref(r, k, v, w, u, s0)
    y_ref, s_ref = wkv.rwkv6_wkv_ref(r, k, v, w, u, s0)
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    C = wkv.wkv_chunk(D)
    assert ck.shape == (2, 3, -(-T // C), D, D)
    assert torch.equal(ck[:, :, 0], s0)
    for n in range(1, ck.shape[2]):
        _, s_n = wkv.rwkv6_wkv_ref(r[:, :n * C], k[:, :n * C], v[:, :n * C],
                                   w[:, :n * C], u, s0)
        assert torch.equal(ck[:, :, n], s_n)


@pytest.mark.parametrize("D,T", [(16, 300), (64, 70)])
@pytest.mark.parametrize("s0_zero,ds_zero", [(True, True), (False, True),
                                             (True, False), (False, False)])
def test_plain_backward_matches_jax_vjp(D, T, s0_zero, ds_zero):
    """T ragged against C (128 at D = 16 gives three chunks, the last
    short; 32 at D = 64 gives three), a zero or random s0 and dS_T."""
    rng = np.random.default_rng(D * 7 + T + 2 * s0_zero + ds_zero)
    B, H = 2, 3
    r, k, v, w, u, dy = _wkv_inputs(rng, B, T, H, D)
    s0 = (np.zeros((B, H, D, D), np.float32) if s0_zero
          else rng.standard_normal((B, H, D, D)).astype(np.float32))
    ds = (np.zeros((B, H, D, D), np.float32) if ds_zero
          else rng.standard_normal((B, H, D, D)).astype(np.float32))
    _, vjp = jax.vjp(j_wkv_ref, *map(jnp.asarray, (r, k, v, w, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    t = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    _, _, ck = wkv.rwkv6_wkv_train_ref(*t, None if s0_zero
                                       else torch.from_numpy(s0))
    got = wkv.rwkv6_wkv_bwd_ref(*t, ck, torch.from_numpy(dy),
                                None if ds_zero else torch.from_numpy(ds))
    assert [g.dtype for g in got] == [torch.float32] * 6
    for g, w_ in zip(got, want):
        _held(g, w_, 1e-5)


def test_plain_backward_matches_autograd_and_casts_bf16():
    """Against torch.autograd through the plain forward's loop (f32), and
    bf16 r/k/v/dy: the same f32 sums of the widened values, dr/dk/dv
    rounded once to bf16."""
    rng = np.random.default_rng(4)
    r, k, v, w, u, dy = map(torch.from_numpy, _wkv_inputs(rng, 2, 45, 2, 16))
    s0 = torch.from_numpy(rng.standard_normal((2, 2, 16, 16)).astype(
        np.float32))
    ds = torch.from_numpy(rng.standard_normal((2, 2, 16, 16)).astype(
        np.float32))
    leaves = [a.clone().requires_grad_(True) for a in (r, k, v, w, u, s0)]
    y, s = wkv.rwkv6_wkv_ref(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
    _, _, ck = wkv.rwkv6_wkv_train_ref(r, k, v, w, u, s0)
    got = wkv.rwkv6_wkv_bwd_ref(r, k, v, w, u, ck, dy, ds)
    for g, w_ in zip(got, want):
        _held(g, w_.numpy(), 1e-5)
    rb, kb, vb, db = (a.bfloat16() for a in (r, k, v, dy))
    _, _, ckb = wkv.rwkv6_wkv_train_ref(rb, kb, vb, w, u, s0)
    gb = wkv.rwkv6_wkv_bwd_ref(rb, kb, vb, w, u, ckb, db, ds)
    gf = wkv.rwkv6_wkv_bwd_ref(rb.float(), kb.float(), vb.float(), w, u,
                               ckb, db.float(), ds)
    assert [g.dtype for g in gb[:3]] == [torch.bfloat16] * 3
    for a, b in zip(gb[:3], gf[:3]):
        assert torch.equal(a, b.bfloat16())
    for a, b in zip(gb[3:], gf[3:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", wkv.HEAD_DIMS)
def test_split_backward_at_the_kernels_cluster(D):
    """The kernel's partition of the rows (``wkv_bwd_plan``: a cluster of
    P CTAs of D / P rows, dv's and c_t's sums per group then in rank
    order) in f32, random s0 and dS_T: within 1e-6 of the plain backward
    and 1e-5 of ``jax.vjp`` of the oracle, each gradient over its max
    |g|."""
    P, rs = wkv.wkv_bwd_plan(D)
    assert P * rs == D and P <= 8 and rs == 16
    rng = np.random.default_rng(D)
    B, H, T = 1, 2, 21          # across a chunk edge where C = 16
    r, k, v, w, u, dy = _wkv_inputs(rng, B, T, H, D)
    s0, ds = (rng.standard_normal((B, H, D, D)).astype(np.float32)
              for _ in range(2))
    t = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    _, _, ck = wkv.rwkv6_wkv_train_ref(*t, torch.from_numpy(s0))
    args = (*t, ck, torch.from_numpy(dy), torch.from_numpy(ds))
    got = wkv.rwkv6_wkv_bwd_split_ref(*args, P=P)
    for g, w_ in zip(got, wkv.rwkv6_wkv_bwd_ref(*args)):
        _held(g, w_.numpy(), 1e-6)
    _, vjp = jax.vjp(j_wkv_ref, *map(jnp.asarray, (r, k, v, w, u, s0)))
    for g, w_ in zip(got, vjp((jnp.asarray(dy), jnp.asarray(ds)))):
        _held(g, w_, 1e-5)


def test_wkv_function_on_cpu_tensors():
    """``ops.rwkv6_wkv`` under autograd is ``WkvFn``: y and the state as the
    serve form gives them, the checkpoints saved, grads to every input
    (and none to an s0 that was not given), the final state's gradient
    used when the state is."""
    rng = np.random.default_rng(8)
    r, k, v, w, u, dy = map(torch.from_numpy, _wkv_inputs(rng, 1, 20, 2, 16))
    leaves = [a.clone().requires_grad_(True) for a in (r, k, v, w, u)]
    calls = wkv.rwkv6_wkv_train_ref.calls, wkv.rwkv6_wkv_bwd_ref.calls
    y, s = ops.rwkv6_wkv(*leaves)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == \
        "WkvFnBackward"
    y_ref, s_ref = ops.rwkv6_wkv(r, k, v, w, u)
    assert y_ref.grad_fn is None
    assert torch.equal(y.detach(), y_ref) and torch.equal(s.detach(), s_ref)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 6 and saved[5].shape == (1, 2, 1, 16, 16)
    ds = torch.randn(s.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
    assert (wkv.rwkv6_wkv_train_ref.calls - calls[0],
            wkv.rwkv6_wkv_bwd_ref.calls - calls[1]) == (1, 1)
    _, _, ck = wkv.rwkv6_wkv_train_ref(r, k, v, w, u)
    want = wkv.rwkv6_wkv_bwd_ref(r, k, v, w, u, ck, dy, ds)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    # the state unused: its gradient is none, and s0's goes back
    s0 = torch.zeros(1, 2, 16, 16, requires_grad=True)
    y2, _ = ops.rwkv6_wkv(*leaves, s0)
    g = torch.autograd.grad((y2 * dy).sum(), [*leaves, s0])
    want = wkv.rwkv6_wkv_bwd_ref(r, k, v, w, u, ck, dy, None)
    for a, b in zip(g, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="s_out"):
        ops.rwkv6_wkv(*leaves, s_out=torch.zeros(1, 2, 16, 16))


class _Ctx:
    def save_for_backward(self, *t):
        self.saved_tensors = t

    def set_materialize_grads(self, value):
        self.materialize = value


def test_wkv_function_sends_cuda_tensors_to_the_kernels(monkeypatch):
    """On CUDA tensors ``WkvFn`` calls kernel 7's training form and its
    backward kernel, never their plain versions: through the ops' CUDA
    implementations (the dispatcher's CUDA key, on CPU tensors)."""
    calls = []

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    fwd = tuple(torch.zeros(1) for _ in range(3))
    bwd = tuple(torch.zeros(1) for _ in range(6))
    monkeypatch.setattr(wkv, "rwkv6_wkv_train_ref", plain)
    monkeypatch.setattr(wkv, "rwkv6_wkv_bwd_ref", plain)
    monkeypatch.setattr(wkv, "rwkv6_wkv_train",
                        lambda *a: calls.append("fwd") or fwd)
    monkeypatch.setattr(wkv, "rwkv6_wkv_bwd",
                        lambda *a: calls.append(("bwd", a[5], a[7])) or bwd)
    ctx = _Ctx()
    t = [torch.zeros(1) for _ in range(5)]
    ds = torch.zeros(1)
    with cuda_route() as route:
        y, s = ops.WkvFn.forward(ctx, *t, None)
        assert y is fwd[0] and s is fwd[1]
        assert ctx.saved_tensors[5] is fwd[2] and ctx.has_s0 is False
        assert ctx.materialize is False
        grads = ops.WkvFn.backward(ctx, torch.zeros(1), ds)
    assert route.ops == ["rwkv6_wkv_train", "rwkv6_wkv_bwd"]
    assert all(a is b for a, b in zip(grads, bwd[:5])) and grads[5] is None
    assert calls[0] == "fwd" and calls[1][0] == "bwd"
    assert calls[1][1] is fwd[2] and calls[1][2] is ds


# ---------------------------------------------------------------------------
# the Mamba scan
# ---------------------------------------------------------------------------

def _scan_inputs(rng, B, S, di, n, dtype):
    a = rng.uniform(0.5, 1.0, (B, S, di, n)).astype(dtype)
    b = rng.standard_normal((B, S, di, n)).astype(dtype)
    h0 = rng.standard_normal((B, di, n)).astype(dtype)
    dh = rng.standard_normal((B, S, di, n)).astype(dtype)
    return a, b, h0, dh


@pytest.mark.parametrize("S", [1, 13, 64])
def test_scan_function_forward_is_the_serve_scan(S):
    rng = np.random.default_rng(S)
    a, b, h0, _ = map(torch.from_numpy, _scan_inputs(rng, 2, S, 5, 4,
                                                     np.float32))
    want = TS._selective_scan(a.clone(), b.clone(), h0)
    got = TS.SelectiveScanFn.apply(a.requires_grad_(True), b, h0)
    assert torch.equal(got.detach(), want)
    with torch.no_grad():
        assert torch.equal(TS._scan(a.clone(), b.clone(), h0), want)


@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_backward_matches_autograd(with_h0):
    rng = np.random.default_rng(3 + with_h0)
    a, b, h0, dh = map(torch.from_numpy, _scan_inputs(rng, 2, 23, 3, 2,
                                                      np.float64))
    leaves = [a.requires_grad_(True), b.requires_grad_(True)]
    if with_h0:
        leaves.append(h0.requires_grad_(True))
    h = h0 if with_h0 else torch.zeros_like(h0)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    want = torch.autograd.grad((torch.stack(hs, 1) * dh).sum(), leaves)
    got = torch.autograd.grad(
        (TS.SelectiveScanFn.apply(a, b, h0 if with_h0 else None) * dh).sum(),
        leaves)
    for g, w_ in zip(got, want):
        assert (g - w_).abs().max() <= 1e-12 * w_.abs().max()


def test_scan_backward_matches_reference_chunked_scan():
    """The reference's chunked scan (chunks of 16 over S = 48, h0 carried)
    under jax.vjp against SelectiveScanFn's backward."""
    rng = np.random.default_rng(9)
    a, b, h0, dh = _scan_inputs(rng, 2, 48, 6, 4, np.float32)

    def chunked(a, b, h0):
        hs = []
        for c in range(0, a.shape[1], 16):
            h_seq, h0 = JS._selective_scan_chunk(a[:, c:c + 16],
                                                 b[:, c:c + 16], h0)
            hs.append(h_seq)
        return jnp.concatenate(hs, axis=1)

    _, vjp = jax.vjp(chunked, *map(jnp.asarray, (a, b, h0)))
    want = vjp(jnp.asarray(dh))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (a, b, h0)]
    got = torch.autograd.grad(
        (TS.SelectiveScanFn.apply(*leaves) * torch.from_numpy(dh)).sum(),
        leaves)
    for g, w_ in zip(got, want):
        _held(g, w_, 1e-5)
