"""The port's training loss against the live JAX reference on the CPU:
``Model.loss`` and its grads against ``jax.value_and_grad(model.loss)``
for the smoke configs of llama2-7b, qwen3-1.7b (qk_norm, tied embedding),
gemma-7b (embed_scale, (1 + w) norm, the gelu GLU) and
granite-moe-3b-a800m (the load-balancing loss, and a batch past the
capacity so assignments drop); ``remat="full"`` against ``"none"``; the
MoE aux loss against the reference's ``_moe_core``; the four families
that once refused now train (their parity: test_torch_train_families.py).

Weights carried over from a JAX ``Model.init`` tree (``from_jax_params``)
in f32 plans (``compute_dtype`` and ``param_dtype`` float32); token ids
from numpy seeds.  Tolerances, fixed before any result was read: the loss
within 1e-5 relative, each grad leaf within 1e-4 of its own max |g|
(sums in other orders: attention's backward, the chunked cross-entropy),
remat against none within 1e-6 of max |g| (the same ops, recomputed)."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.training.train_step import _value_and_grad  # noqa: E402


def _pair(arch, **plan_kw):
    jcfg = j_get_config(arch).smoke_config()
    jm = j_build_model(jcfg, j_local_plan(param_dtype=jnp.float32,
                                          compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch).smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32, **plan_kw),
                     device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(vocab, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


# granite at (4, 520): 2080 tokens x top-2 = 4160 assignments > 4096, so
# the capacity is capacity_factor's share and some assignments drop
@pytest.mark.parametrize("arch,B,S", [
    ("llama2-7b", 2, 24), ("qwen3-1.7b", 2, 24), ("gemma-7b", 2, 24),
    ("granite-moe-3b-a800m", 2, 24), ("granite-moe-3b-a800m", 4, 520)])
def test_loss_and_grads_match_reference(arch, B, S):
    jm, jp, tm, tp = _pair(arch)
    inp, lab = _tokens(jm.cfg.vocab_size, B, S)
    if arch.startswith("granite"):
        assert (B * S * jm.cfg.top_k > 4096) == (S > 24)
    want_loss, want = jax.value_and_grad(jm.loss)(jp, jnp.asarray(inp),
                                                  jnp.asarray(lab))
    loss, grads = _value_and_grad(tm, tp, torch.from_numpy(inp).long(),
                                  torch.from_numpy(lab).long())
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


def test_remat_full_equals_none():
    _, _, tm, tp = _pair("granite-moe-3b-a800m")
    tm_r = build_model(tm.cfg, local_plan(param_dtype=torch.float32,
                                          compute_dtype=torch.float32,
                                          remat="full"), device="cpu")
    inp, lab = (torch.from_numpy(a).long()
                for a in _tokens(tm.cfg.vocab_size, 2, 24, seed=1))
    l0, g0 = _value_and_grad(tm, tp, inp, lab)
    l1, g1 = _value_and_grad(tm_r, tp, inp, lab)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert (a - b).abs().max() <= 1e-6 * max(b.abs().max(), 1e-30)


def test_remat_takes_two_values():
    with pytest.raises(ValueError, match="remat"):
        local_plan(remat="some")


def test_moe_aux_matches_reference_core():
    """The Switch-style aux of ``_moe_core`` against the reference's."""
    cfg = get_config("granite-moe-3b-a800m").smoke_config()
    rng = np.random.default_rng(5)
    T, d, E, f = 40, cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    x = rng.standard_normal((T, d)).astype(np.float32)
    rw = rng.standard_normal((d, E)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.1
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    cap = T * cfg.top_k
    _, want = JM._moe_core(None, jnp.asarray(x), jnp.asarray(rw),
                           *map(jnp.asarray, ws), cfg=j_get_config(
                               "granite-moe-3b-a800m").smoke_config(),
                           e_pad=E, capacity=cap, activation=cfg.activation)
    y, aux = TM._moe_core(torch.from_numpy(x), torch.from_numpy(rw),
                          *map(torch.from_numpy, ws), cfg=cfg, e_pad=E,
                          capacity=cap, activation=cfg.activation,
                          want_aux=True)
    np.testing.assert_allclose(float(aux), float(want), rtol=1e-6)
    _, none = TM._moe_core(torch.from_numpy(x), torch.from_numpy(rw),
                           *map(torch.from_numpy, ws), cfg=cfg, e_pad=E,
                           capacity=cap, activation=cfg.activation)
    assert none is None


def test_canonicalize_grads_is_identity():
    _, _, tm, tp = _pair("qwen3-1.7b")
    assert tm.canonicalize_grads(tp) is tp


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b", "minicpm3-4b",
                                  "hubert-xlarge"])
def test_loss_refuses_families_not_ported(arch):
    """The four families that once refused training now refuse nothing:
    ``Model.check_trainable`` is gone and ``Model.loss`` gives a finite
    loss with a gradient (their parity: tests/test_torch_train_families.py)."""
    cfg = get_config(arch).smoke_config()
    m = build_model(cfg, local_plan(param_dtype=torch.float32), device="cpu")
    assert not hasattr(m, "check_trainable")
    p = m.init(torch.Generator().manual_seed(0))
    w = p["layers"]["norm1"]["scale"].requires_grad_(True)
    inputs = (torch.zeros(1, 4, cfg.d_model) if cfg.input_kind == "embeds"
              else torch.zeros(1, 4, dtype=torch.long))
    loss = m.loss(p, inputs, torch.zeros(1, 4, dtype=torch.long))
    assert torch.isfinite(loss) and loss.grad_fn is not None
    assert torch.autograd.grad(loss, w)[0].shape == w.shape
