"""The port's training step against the live JAX reference on the CPU:
AdamW (``adamw_update``, ``_schedule``, ``global_norm``), three train
steps end to end at grad_accum 1 and 2 against the reference's jitted
``make_train_step``, ``TokenPipeline``'s batches, checkpoints written by
one package and restored by the other, a resumed run against an
uninterrupted one, and ``launch/train.py`` on the CPU.

qwen3-1.7b's smoke config in f32 plans, weights and optimizer state
carried over (``from_jax_params``, ``from_jax_opt_state``).  Tolerances,
fixed before any result was read: AdamW's params, m and v within 1e-6
of each leaf's max |x| over 3 steps on identical inputs (an element that
cancels to near 0 carries a few ulps of the terms that made it); the
schedule and the global norm within 1e-6 relative; train losses within 1e-5 relative; batches,
checkpoint leaves and the resumed run's losses exact."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.training import checkpoint as JC  # noqa: E402
from repro.training import data as JD  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_opt_state  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.training import checkpoint as TC  # noqa: E402
from repro_torch.training import data as TD  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

ARCH = "qwen3-1.7b"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _models():
    jm = j_build_model(j_get_config(ARCH).smoke_config(),
                       j_local_plan(param_dtype=jnp.float32,
                                    compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH).smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32), device="cpu")
    return jm, jp, tm


def _tp(jp):
    return from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_three_steps():
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}
    params = {"x": _tree(rng, shapes), "y": rng.standard_normal(
        (3, 3)).astype(np.float32)}
    grads = [{"x": _tree(rng, shapes), "y": rng.standard_normal(
        (3, 3)).astype(np.float32) * s} for s in (0.1, 3.0, 0.5)]
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         grad_clip=1.0)
    jcfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          grad_clip=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    js = JO.init_opt_state(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    ts = TO.init_opt_state(tp)
    for g in grads:
        jp, js, jn = JO.adamw_update(jcfg, jax.tree.map(jnp.asarray, g), js,
                                     jp)
        tp, ts, tn = TO.adamw_update(
            cfg, jax.tree.map(torch.from_numpy, g), ts, tp)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            a, b = _np(a), np.asarray(b)
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("step", [0.0, 2.0, 5.0, 6.0, 50.0, 100.0, 120.0])
def test_schedule_matches_reference(step):
    """Warmup (steps below 5), the cosine's start (5), its middle and its
    end (100, and past it)."""
    cfg = TO.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    jcfg = JO.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    want = float(JO._schedule(jcfg, jnp.float32(step)))
    got = float(TO._schedule(cfg, torch.tensor(step)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if step >= 100:
        np.testing.assert_allclose(got, 0.1 * 3e-3, rtol=1e-6)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = {"b": _tree(rng, {"u": (9, 4), "w": (3,)}),
            "a": rng.standard_normal((17,)).astype(np.float32)}
    want = float(JO.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(TO.global_norm(jax.tree.map(torch.from_numpy, tree)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# train steps end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_train_steps_match_reference(grad_accum):
    """Losses within 1e-5 relative.  Parameters within 2 lr_t summed over
    the steps: AdamW's first step moves each weight by about +-lr_t
    (m / sqrt(v) is the gradient's sign), so a near-zero gradient whose
    sign differs between the two sums moves that weight by 2 lr_t; the
    arithmetic itself is held exactly by the AdamW test and the grads by
    ``test_torch_train.py``.  Besides, at most 1 in 1000 weights may be
    off by more than 1e-5 relative."""
    jm, jp, tm = _models()
    tp = _tp(jp)
    lr = 3e-3
    jcfg = JO.AdamWConfig(lr=lr, warmup_steps=5, total_steps=3)
    tcfg = TO.AdamWConfig(lr=lr, warmup_steps=5, total_steps=3)
    jstep = jax.jit(JS.make_train_step(jm, jcfg, grad_accum=grad_accum))
    tstep = TS.make_train_step(tm, tcfg, grad_accum=grad_accum)
    js, ts = JO.init_opt_state(jp), TO.init_opt_state(tp)
    jpipe = JD.TokenPipeline(JD.DataConfig(jm.cfg.vocab_size, 4, 16))
    tpipe = TD.TokenPipeline(TD.DataConfig(tm.cfg.vocab_size, 4, 16),
                             device="cpu")
    budget = 0.0
    for i in range(3):
        jp, js, jmet = jstep(jp, js, *jpipe.next_batch())
        tp, ts, tmet = tstep(tp, ts, *tpipe.next_batch())
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        budget += 2 * float(JO._schedule(jcfg, jnp.float32(i + 1)))
    n_off = n = 0
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        a, b = a.numpy(), np.asarray(b)
        assert np.abs(a - b).max() <= budget + 1e-6
        n_off += int((np.abs(a - b) > 1e-5 * np.abs(b) + 1e-7).sum())
        n += a.size
    assert n_off <= n // 1000, (n_off, n)


def test_metrics_stay_on_the_device_and_params_need_no_grad():
    _, jp, tm = _models()
    tp = _tp(jp)
    step = TS.make_train_step(tm, TO.AdamWConfig(lr=1e-3))
    pipe = TD.TokenPipeline(TD.DataConfig(tm.cfg.vocab_size, 2, 8),
                            device="cpu")
    tp2, st, met = step(tp, TO.init_opt_state(tp), *pipe.next_batch())
    assert tp2 is tp
    assert all(not t.requires_grad for t in tree_leaves(tp))
    assert isinstance(met["loss"], torch.Tensor) and met["loss"].dim() == 0
    assert isinstance(met["grad_norm"], torch.Tensor)
    loss = TS.make_eval_step(tm)(tp, *pipe.next_batch())
    assert loss.grad_fn is None


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_token_pipeline_is_token_exact_and_resumes():
    jcfg = JD.DataConfig(vocab_size=97, batch=3, seq_len=20, seed=4)
    tcfg = TD.DataConfig(vocab_size=97, batch=3, seq_len=20, seed=4)
    jpipe, tpipe = JD.TokenPipeline(jcfg), TD.TokenPipeline(tcfg,
                                                            device="cpu")
    want = [jpipe.next_batch() for _ in range(5)]
    for wi, wl in want:
        ti, tl = tpipe.next_batch()
        assert ti.dtype == tl.dtype == torch.int64
        np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))
    assert tpipe.state() == jpipe.state() == {"seed": 4, "step": 5}
    resumed = TD.TokenPipeline(tcfg, step=3, device="cpu")
    for wi, wl in want[3:]:
        ti, tl = resumed.next_batch()
        np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(jp):
    """A reference (params, opt_state) after some made-up moments."""
    js = JO.init_opt_state(jp)
    js = {"m": jax.tree.map(lambda a: a * 0.5 + 0.25, jp),
          "v": jax.tree.map(lambda a: a * a + 0.125, jp),
          "step": jnp.asarray(7, jnp.int32)}
    return jp, js


def _equal(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_restores_into_port(tmp_path):
    _, jp, _ = _models()
    jp, js = _state(jp)
    JC.save_checkpoint(tmp_path, 7, (jp, js), meta={"arch": ARCH})
    tmpl = (_tp(jp), from_jax_opt_state(
        jax.tree.map(np.asarray, JO.init_opt_state(jp)), device="cpu"))
    (tp, ts), manifest = TC.restore_checkpoint(tmp_path, tmpl)
    assert manifest["step"] == 7 and TC.latest_step(tmp_path) == 7
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 7
    _equal(tree_leaves((tp, ts)), jax.tree.leaves((jp, js)))


def test_port_checkpoint_restores_into_reference(tmp_path):
    _, jp, _ = _models()
    jp, js = _state(jp)
    tstate = (_tp(jp), from_jax_opt_state(jax.tree.map(np.asarray, js),
                                          device="cpu"))
    TC.save_checkpoint(tmp_path, 7, tstate, meta={"arch": ARCH})
    assert JC.latest_step(tmp_path) == 7
    (rp, rs), manifest = JC.restore_checkpoint(
        tmp_path, (jp, JO.init_opt_state(jp)))
    assert manifest["step"] == 7
    _equal(tree_leaves(tstate), jax.tree.leaves((rp, rs)))


def test_bf16_leaves_stored_as_the_reference_stores_them(tmp_path):
    """bf16 leaves go to disk as the reference's numpy writes them (2-byte
    ``V`` records of the same bits) and come back bit for bit."""
    x = torch.tensor([1.0, -2.5, 3.140625, 0.0], dtype=torch.bfloat16)
    TC.save_checkpoint(tmp_path, 1, {"w": x})
    JC.save_checkpoint(tmp_path / "ref", 1,
                       {"w": jnp.asarray(x.float().numpy(), jnp.bfloat16)})
    ours = np.load(tmp_path / "step_00000001" / "shard_0.npz")["leaf_0"]
    theirs = np.load(tmp_path / "ref" / "step_00000001" /
                     "shard_0.npz")["leaf_0"]
    assert ours.dtype.kind == theirs.dtype.kind == "V"
    assert ours.tobytes() == theirs.tobytes()
    for d in (tmp_path, tmp_path / "ref"):
        got, _ = TC.restore_checkpoint(d, {"w": torch.zeros(4,
                                                            dtype=x.dtype)})
        assert torch.equal(got["w"], x)


def _train(tm, tp, steps, start=0, state=None, ckpt=None, save_at=None):
    cfg = TO.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6)
    step_fn = TS.make_train_step(tm, cfg)
    st = state if state is not None else TO.init_opt_state(tp)
    pipe = TD.TokenPipeline(TD.DataConfig(tm.cfg.vocab_size, 2, 12),
                            step=start, device="cpu")
    losses = []
    for i in range(start, steps):
        tp, st, met = step_fn(tp, st, *pipe.next_batch())
        losses.append(float(met["loss"]))
        if save_at == i + 1:
            TC.save_checkpoint(ckpt, i + 1, (tp, st))
    return losses


def test_resumed_run_equals_uninterrupted(tmp_path):
    _, jp, tm = _models()
    whole = _train(tm, _tp(jp), 6, ckpt=tmp_path, save_at=3)
    # a fresh model and optimizer, restored from step 3
    tm2 = build_model(tm.cfg, tm.plan, device="cpu")
    fresh = tm2.init(torch.Generator().manual_seed(1))
    (tp, st), manifest = TC.restore_checkpoint(
        tmp_path, (fresh, TO.init_opt_state(fresh)))
    assert manifest["step"] == 3
    resumed = _train(tm2, tp, 6, start=3, state=st)
    assert resumed == whole[3:]


def test_train_cli_runs_falls_and_resumes(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--ckpt", str(tmp_path), "--ckpt-every", "4"]
    out = t_train.main(argv + ["--steps", "8"])
    assert out["last_loss"] < out["first_loss"]
    assert TC.latest_step(tmp_path) == 8
    out2 = t_train.main(argv + ["--steps", "10"])
    text = capsys.readouterr().out
    assert "resumed from step 8" in text
    assert "step    9 loss" in text and "step    8 loss" in text
    assert np.isfinite(out2["last_loss"])


def test_training_entry_points_default_to_cuda():
    import inspect
    from repro_torch.launch import quickstart, train_small
    assert inspect.signature(TD.TokenPipeline.__init__).parameters[
        "device"].default == "cuda"
    assert inspect.signature(quickstart.main).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would train")
    with pytest.raises((AssertionError, RuntimeError)):
        t_train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    with pytest.raises((AssertionError, RuntimeError)):
        train_small.main(["--steps", "1", "--ckpt", ""])
