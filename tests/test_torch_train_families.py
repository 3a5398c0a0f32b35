"""Training of the families that once refused it, against the live JAX
reference on the CPU: ``Model.loss`` and every grad leaf against
``jax.value_and_grad`` of the reference ``Model.loss`` for the smoke
configs of hymba-1.5b (the window masking keys at S = 24 > 16, and the
Mamba scan's
``SelectiveScanFn``), minicpm3-4b (MLA: kernel 1 at q's head dim with v
zero-padded, the pad's gradient cut off) and hubert-xlarge (frame
embeddings in, bidirectional attention); ``remat="full"`` against none
for the two recurrent families; ``canonicalize_grads`` the identity;
MLA's pad and shared rope key under autograd; AdamW's slices bit for bit
its whole-leaf update.  rwkv6-3b's parity (kernel 7's gradient through
``ops.WkvFn``): test_torch_train_rwkv.py; three AdamW steps of each:
test_torch_train_families_step.py; ``launch/train.py``:
test_torch_train_cli.py.

Weights carried over from a JAX ``Model.init`` tree (``from_jax_params``)
in f32 plans.  Tolerances, PR 27's, fixed before any result was read:
the loss within 1e-5 relative, each grad leaf within 1e-4 of its own
max |g|; remat against none within 1e-6 of max |g| (the same ops,
recomputed)."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training.train_step import _value_and_grad  # noqa: E402

ARCHS = ["hymba-1.5b", "minicpm3-4b", "hubert-xlarge"]


def _pair(arch):
    jcfg = j_get_config(arch).smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch).smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32),
                     device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(cfg, B, S, seed=0):
    """(inputs, labels) as numpy: token ids, or for the encoder f32 frame
    embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeds":
        inp = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        inp = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return inp, rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _torch(inp, lab):
    t = torch.from_numpy(inp)
    return (t if t.is_floating_point() else t.long(),
            torch.from_numpy(lab).long())


def held_to_reference(arch, B=2, S=24):
    """Loss and grads of the smoke config of ``arch`` at (B, S) against
    the reference's (the tolerances of the module docstring)."""
    jm, jp, tm, tp = _pair(arch)
    inp, lab = _batch(jm.cfg, B, S)
    want_loss, want = jax.value_and_grad(jm.loss)(jp, jnp.asarray(inp),
                                                  jnp.asarray(lab))
    loss, grads = _value_and_grad(tm, tp, *_torch(inp, lab))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_leaves = jax.tree.leaves(want)
    got_leaves = tree_leaves(grads)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert g.shape == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (err,
                                                          np.abs(w).max())
    assert tm.canonicalize_grads(grads) is grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    held_to_reference(arch)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_remat_full_equals_none(arch):
    """Each layer recomputed in the backward: ``WkvFn`` and
    ``SelectiveScanFn`` run their forwards again under the checkpoint."""
    cfg = get_config(arch).smoke_config()
    plans = [local_plan(param_dtype=torch.float32,
                        compute_dtype=torch.float32, remat=r)
             for r in ("none", "full")]
    params = build_model(cfg, plans[0], device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = _torch(*_batch(cfg, 2, 24, seed=1))
    (l0, g0), (l1, g1) = (_value_and_grad(build_model(cfg, p, device="cpu"),
                                          params, *batch) for p in plans)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert (a - b).abs().max() <= 1e-6 * max(b.abs().max(), 1e-30)


def test_mla_pad_passes_no_gradient():
    """``_flash_padded``: v's zero pad gets an exactly zero gradient, and
    the shared rope key's expand over heads sums its gradient (against
    the per-head keys' gradients summed)."""
    from repro_torch.models import attention as TA
    g = torch.Generator().manual_seed(3)
    B, S, H = 2, 12, 3
    q, k = (torch.randn(B, S, H, 24, generator=g) for _ in range(2))
    v = torch.randn(B, S, H, 16, generator=g, requires_grad=True)
    kr = torch.randn(B, S, 8, generator=g, requires_grad=True)
    kn = k[..., :16].clone().requires_grad_(True)
    kk = torch.cat([kn, kr[:, :, None, :].expand(B, S, H, 8)], dim=-1)
    o = TA._flash_padded(q.requires_grad_(True), kk, v, scale=0.25)
    assert o.shape == (B, S, H, 16)
    do = torch.randn(o.shape, generator=g)
    dq, dkr, dv = torch.autograd.grad((o * do).sum(), (q, kr, v))
    # the same attention with every head's rope key its own leaf
    kr_h = kr.detach()[:, :, None, :].expand(B, S, H, 8).clone() \
        .requires_grad_(True)
    vp = torch.nn.functional.pad(v.detach(), (0, 16)).requires_grad_(True)
    kp = torch.cat([kn.detach(), kr_h], -1)
    kp = torch.nn.functional.pad(kp, (0, 8))
    qp = torch.nn.functional.pad(q.detach(), (0, 8))
    from repro_torch.kernels import ops
    op = ops.flash_attention(qp.transpose(1, 2).requires_grad_(True),
                             kp.transpose(1, 2), vp.transpose(1, 2),
                             scale=0.25).transpose(1, 2)
    dkr_h, dvp = torch.autograd.grad(
        (op * torch.nn.functional.pad(do, (0, 16))).sum(), (kr_h, vp))
    torch.testing.assert_close(dkr, dkr_h.sum(2), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dv, dvp[..., :16], rtol=0, atol=0)
    assert torch.isfinite(dq).all()


def test_adamw_slices_are_the_whole_leaf_bit_for_bit(monkeypatch):
    """The update in slices of the first axis (``optimizer.SLICE``
    elements) gives the bits of the whole-leaf update: every op is
    elementwise."""
    g = torch.Generator().manual_seed(5)
    params = {"a": torch.randn(7, 5, 3, generator=g),
              "b": torch.randn(11, generator=g), "c": torch.randn((), )}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in params.items()}
             for _ in range(3)]
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    out = []
    for slice_ in (TO.SLICE, 4):
        monkeypatch.setattr(TO, "SLICE", slice_)
        p = {k: v.clone() for k, v in params.items()}
        st = TO.init_opt_state(p)
        for gr in grads:
            p, st, _ = TO.adamw_update(cfg, gr, st, p)
        out.append((p, st))
    assert len(list(TO._slices(*(params["a"],) * 4))) == 7
    for a, b in zip(tree_leaves(out[0]), tree_leaves(out[1])):
        assert torch.equal(a, b)
