"""The port's mesh, elastic and grad-accumulation rules against the live
JAX reference: ``plan_remesh`` for 1-600 survivors at every TP degree,
``make_mesh_for``'s degrees, ``make_production_mesh``'s refusal,
``choose_grad_accum`` for every assigned cell; and ``recover`` resuming
a smoke run with the uninterrupted run's next loss."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import os

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import ASSIGNED as J_ASSIGNED  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import elastic as JE  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, elastic, mesh  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.training.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.training.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            init_opt_state)
from repro_torch.training.train_step import make_train_step  # noqa: E402


@pytest.mark.parametrize("tp", range(1, 17))
def test_plan_remesh_equals_the_reference(tp):
    for n in range(1, 601):
        got, want = elastic.plan_remesh(n, tp=tp), JE.plan_remesh(n, tp=tp)
        assert (got.survivors, got.data, got.model, got.dropped,
                got.usable) == (want.survivors, want.data, want.model,
                                want.dropped, want.usable), n


@pytest.mark.parametrize("want_model", [0, 1, 2, 4, 8, 16])
def test_make_mesh_for_degrees_equal_the_reference(want_model, monkeypatch):
    # the reference's rule, its device list and mesh stubbed: the degrees
    # it would hand ``jax.make_mesh``
    monkeypatch.setattr(JM.jax, "devices", lambda: list(range(600)))
    monkeypatch.setattr(JM.jax, "make_mesh",
                        lambda shape, axes, devices: dict(zip(axes, shape)))
    for n in range(1, 601):
        want = JM.make_mesh_for(n, want_model=want_model)
        got = mesh.make_mesh_for(n, want_model=want_model, device="cpu")
        assert got.shape == want, n
        assert got.size == n
    assert mesh.plan_for(mesh.make_mesh_for(8, device="cpu")).tp == 8


def test_make_production_mesh_refuses_as_the_reference(monkeypatch):
    monkeypatch.setattr(JM.jax, "devices", lambda: [0])
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="needs"):
            JM.make_production_mesh(multi_pod=multi)
        with pytest.raises(RuntimeError, match="needs"):
            mesh.make_production_mesh(multi_pod=multi, device="cpu")
    monkeypatch.setattr(mesh, "visible_devices", lambda device: 512)
    m = mesh.make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}


def _reference_choose_grad_accum(monkeypatch):
    """The reference's ``choose_grad_accum``.  Its module forces 512 host
    devices through ``XLA_FLAGS`` on import; the flag is put back."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch.dryrun import choose_grad_accum
    return choose_grad_accum


@pytest.mark.parametrize("dp", [1, 16])
def test_choose_grad_accum_equals_the_reference(dp, monkeypatch):
    ref = _reference_choose_grad_accum(monkeypatch)
    for arch in J_ASSIGNED:
        for name in SHAPES:
            assert dryrun.choose_grad_accum(get_config(arch), SHAPES[name],
                                            dp) == \
                ref(j_get_config(arch), J_SHAPES[name], dp), (arch, name)


def test_recover_resumes_a_smoke_run(tmp_path):
    """Two AdamW steps, a checkpoint, then the third step's loss: run on
    in the same process, and after ``recover`` from the checkpoint."""
    cfg = get_config("qwen3-1.7b").smoke_config()
    model = build_model(cfg, local_plan(param_dtype=torch.float32),
                        device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=1,
                                              total_steps=3))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 4, 32), device="cpu")
    for _ in range(2):
        params, opt, _ = step(params, opt, *pipe.next_batch())
    save_checkpoint(tmp_path, 2, (params, opt), meta={"arch": cfg.name})
    saved = [t.clone() for t in tree_leaves((params, opt))]
    batch = pipe.next_batch()
    want = float(step(params, opt, *batch)[2]["loss"])

    model2, params2, opt2, manifest, decision = elastic.recover(
        cfg, tmp_path, n_surviving=17, device="cpu")
    assert manifest["step"] == 2 and int(opt2["step"]) == 2
    assert (decision.survivors, decision.data, decision.model,
            decision.dropped) == (1, 1, 1, 0)
    assert model2.plan.tp == 1 and model2.device == torch.device("cpu")
    for a, b in zip(saved, tree_leaves((params2, opt2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    step2 = make_train_step(model2, AdamWConfig(lr=3e-3, warmup_steps=1,
                                                total_steps=3))
    got = float(step2(params2, opt2, *batch)[2]["loss"])
    assert got == pytest.approx(want, abs=1e-5)
