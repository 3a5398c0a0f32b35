"""The port's shapes and roofline against the live JAX reference:
``SHAPES``, ``ASSIGNED``, ``runnable_cells`` and ``input_specs``' shapes
and dtypes for every assigned arch; ``model_flops``; ``RooflineReport``'s
row with the reference's TPU spec substituted; the H100 defaults and
``bound_of``."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.analysis import roofline as JR  # noqa: E402
from repro.configs import ASSIGNED as J_ASSIGNED  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import input_specs as j_input_specs  # noqa: E402
from repro.configs import runnable_cells as j_runnable_cells  # noqa: E402
from repro_torch.analysis import roofline as R  # noqa: E402
from repro_torch.configs import (ASSIGNED, SHAPES, get_config,  # noqa: E402
                                 input_specs, runnable_cells)

DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


def test_shapes_and_assigned_equal_the_reference():
    assert ASSIGNED == J_ASSIGNED
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        j = J_SHAPES[name]
        assert (s.name, s.kind, s.seq_len, s.global_batch) == \
            (j.name, j.kind, j.seq_len, j.global_batch)


@pytest.mark.parametrize("arch", J_ASSIGNED)
def test_runnable_cells_and_input_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    cells = runnable_cells(cfg)
    assert [s.name for s in cells] == \
        [s.name for s in j_runnable_cells(jcfg)]
    for shape in cells:
        got = input_specs(cfg, shape)
        want = j_input_specs(jcfg, J_SHAPES[shape.name])
        assert list(got) == list(want), shape.name
        for key, spec in want.items():
            t = got[key]
            assert t.is_meta, (shape.name, key)
            assert tuple(t.shape) == tuple(spec.shape), (shape.name, key)
            assert t.dtype == DTYPES[spec.dtype.type], (shape.name, key)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_the_reference(kind):
    for n, tokens in ((1_720_567_808, 4096 * 256), (3, 1), (0, 7)):
        assert R.model_flops(n, kind, tokens) == \
            JR.model_flops(n, kind, tokens)


V5E = R.HWSpec(name="tpu-v5e", peak_flops_bf16=197e12, hbm_bw=819e9,
               link_bw=50e9, hbm_bytes=16e9)


@pytest.mark.parametrize("flops,n_bytes,coll,model,chips", [
    (1.5e15, 3.2e12, 4e9, 9.0e14, 256),
    (2e9, 8e11, 0.0, 1e9, 1),
    (0.0, 0.0, 0.0, 0.0, 512),
])
def test_roofline_row_equals_the_reference_on_its_spec(flops, n_bytes, coll,
                                                       model, chips):
    kw = dict(arch="qwen3-1.7b", shape="train_4k", mesh="16x16",
              chips=chips, flops_per_dev=flops, bytes_per_dev=n_bytes,
              coll_bytes_per_dev=coll, coll_breakdown={"all-reduce": coll},
              model_flops_total=model, peak_mem_per_dev=7.5e9)
    assert R.RooflineReport(**kw, hw=V5E).row() == JR.RooflineReport(
        **kw).row()


def test_roofline_terms_on_a_count_and_the_h100_defaults():
    hw = R.HW
    assert (hw.hbm_bw, hw.peak_flops_bf16, hw.peak_flops_f32,
            hw.peak_ops_int8, hw.hbm_bytes) == (3.35e12, 989e12, 67e12,
                                                1979e12, 80e9)
    assert [hw.peak(n) for n in ("bf16", "f32", "int8")] == \
        [989e12, 67e12, 1979e12]
    rep = R.roofline_terms(arch="a", shape="s", mesh="1x1", chips=1,
                           cost={"flops": 989e9, "bytes": 6.7e9},
                           model_flops_total=494.5e9, peak_mem=1e9)
    row = rep.row()
    assert row["t_compute_s"] == pytest.approx(1e-3)
    assert row["t_memory_s"] == pytest.approx(2e-3)
    assert row["t_collective_s"] == 0.0 and row["bottleneck"] == "memory"
    assert row["roofline_fraction"] == pytest.approx(0.25)
    assert row["useful_flops_ratio"] == pytest.approx(0.5)


def test_bound_of_takes_the_larger_term():
    assert R.bound_of(3.35e9, 1, "bf16") == (pytest.approx(1.0), "bytes")
    assert R.bound_of(1, 67e9, "f32") == (pytest.approx(1.0), "operations")
    ms, by = R.bound_of(1979e9, 1979e9 * 2, "int8")
    assert by == "bytes" and ms == pytest.approx(1979e9 / 3.35e12 * 1e3)
    assert R.peak_name(torch.float32, torch.bfloat16) == "bf16"
    assert R.peak_name(torch.int8) == "int8"
    assert R.peak_name(torch.float32) == "f32"


@pytest.mark.parametrize("S,causal,window", [
    (1, True, 0), (5, True, 0), (8, True, 3), (8, True, 8), (9, False, 0),
    (9, False, 4), (9, False, 9)])
def test_attn_pairs_counts_the_mask(S, causal, window):
    from repro_torch.kernels.flash_attention import _mask
    want = int(_mask(S, causal, window, "cpu").sum())
    assert R.attn_pairs(S, causal, window) == want
