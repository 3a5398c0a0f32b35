"""Package rules of the port: it never imports JAX or the JAX package, its
entry points default to CUDA, and the kernel dispatcher never hands a CUDA
tensor to a plain version."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import FleetSim, oversubscribe
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as dense_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import int8_matmul as i8_mod
from repro_torch.kernels import paged_decode_attention as paged_mod
from repro_torch.kernels import paged_prefill_attention as prefill_mod
from repro_torch.kernels import rwkv6_wkv as wkv_mod
from repro_torch.launch import fleet as launch_fleet
from repro_torch.launch import oversub as launch_oversub
from repro_torch.models import Model, build_model, layers, local_plan
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.serving import EngineSpec, serving_plan

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(repro_torch.__file__).resolve().parent


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts" / "flash_turns.py"]
    assert len(files) > 10 and all(f.exists() for f in files[-2:])
    return files


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_import_scan_covers_the_step_programs_and_sampling():
    """The scan above reaches the modules that run the serving steps as
    CUDA graphs and draw jax.random's keys."""
    scanned = {p.relative_to(PKG).as_posix() for p in _sources()
               if PKG in p.parents}
    assert {"models/prng.py", "serving/graphs.py", "core/traces.py",
            "core/__init__.py"} <= scanned


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_nothing_built_at_import():
    """Importing the kernel modules compiles and loads nothing."""
    assert build._LIBS == {}
    for mod in (flash_mod, paged_mod, prefill_mod, dense_mod, wkv_mod,
                i8_mod):
        assert not mod._kernel.cache_info().currsize
    assert not paged_mod._lse_kernel.cache_info().currsize


def test_every_kernel_source_is_built():
    """``build_all`` builds every ``csrc/*.cu``, one library each."""
    assert sorted(build.SOURCES) == sorted(
        p.stem for p in build.CSRC.glob("*.cu"))
    assert "int8_matmul" in build.SOURCES


@pytest.mark.parametrize("fn", [
    build_model, Model.__init__, convert.from_jax_params, layers.dense_init,
    layers.embed_init, layers.rope_freqs, layers.mlp_init,
    layers.gelu_mlp_init, TA.init_gqa,
    TA.kv_index, TA.init_paged_attn_cache, TA.init_attn_cache,
    Model.init_cache, TS.init_rwkv_tmix, TS.init_rwkv_cmix,
    TS.init_rwkv_state, TM.init_moe, TS.init_mamba, TS.init_mamba_state,
    EngineSpec.build, FleetSim.__init__, oversubscribe.sweep,
    oversubscribe.FleetOversubPlanner.__init__, launch_fleet.make_fleet,
    launch_fleet.run_drill, launch_fleet.run_measured_drill,
    launch_oversub.run_sweep, launch_oversub.run_fleet,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_serve_cli_defaults_to_cuda():
    """Without --device the CLI serves on CUDA (and so fails where there
    is none)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would serve")
    from repro_torch.launch import serve
    with pytest.raises((AssertionError, RuntimeError)):
        serve.main(["--smoke", "--requests", "1"])


@pytest.mark.parametrize("main", [launch_fleet.main, launch_oversub.main],
                         ids=["fleet", "oversub"])
def test_fleet_clis_default_to_cuda(main):
    """Without --device the fleet and oversubscription CLIs put their
    physics on CUDA (and so fail where there is none)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises((AssertionError, RuntimeError)):
        main([])


class _FakeCuda:
    """Stands in for a CUDA tensor where there is no card: the dispatcher
    routes on ``.device``, and on ``requires_grad`` (an input that needs no
    gradient takes the serve form)."""
    device = torch.device("cuda", 0)
    requires_grad = False


# ops entry -> (module, kernel wrapper, plain versions it must not reach,
# tensor arguments)
DISPATCH = {
    "flash_attention": (flash_mod, "flash_attention",
                        ("flash_attention_ref",), 3),
    "paged_decode_attention": (paged_mod, "paged_decode_attention",
                               ("paged_decode_attention_ref",), 5),
    "paged_decode_attention_lse": (paged_mod, "paged_decode_attention_lse",
                                   ("paged_decode_attention_lse_ref",), 6),
    "paged_prefill_attention": (prefill_mod, "paged_prefill_attention",
                                ("paged_prefill_attention_ref",), 5),
    "paged_prefill_attention_lse": (prefill_mod,
                                    "paged_prefill_attention_lse",
                                    ("paged_prefill_attention_lse_ref",), 6),
    "paged_verify_attention": (prefill_mod, "paged_verify_attention",
                               ("paged_prefill_attention_ref",), 5),
    "decode_attention": (dense_mod, "decode_attention",
                         ("decode_attention_ref", "flash_decode_ref",
                          "swa_decode_ref"), 4),
    "rwkv6_wkv": (wkv_mod, "rwkv6_wkv", ("rwkv6_wkv_ref",), 6),
    "int8_matmul": (i8_mod, "int8_matmul", ("int8_matmul_ref",), 4),
    "int8_matmul_quantized": (i8_mod, "int8_matmul_quantized",
                              ("int8_matmul_quantized_ref",), 2),
}
# ops entries that are plain torch on every device, as they are plain jnp
# in the reference (the quantizers around kernel 6)
PLAIN_EVERYWHERE = {"quantize_rows", "quantize_cols"}


def test_dispatcher_covers_every_ops_entry():
    assert set(DISPATCH) | PLAIN_EVERYWHERE == set(ops.__all__)
    assert not set(DISPATCH) & PLAIN_EVERYWHERE


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatcher_sends_cuda_tensors_to_the_kernel(monkeypatch, name):
    mod, wrapper, plains, n_args = DISPATCH[name]
    calls = []
    monkeypatch.setattr(mod, wrapper,
                        lambda *a, **k: calls.append(a) or "kernel")

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    for ref in plains:
        monkeypatch.setattr(mod, ref, plain)
    args = [_FakeCuda() for _ in range(n_args)]
    assert getattr(ops, name)(*args) == "kernel"
    assert len(calls) == 1


@pytest.mark.parametrize("name,kw", [("flash_attention", {"window": 16}),
                                     ("decode_attention", {"ring": True})],
                         ids=["flash_window", "decode_ring"])
def test_dispatcher_sends_cuda_tensors_to_the_kernel_in_every_form(
        monkeypatch, name, kw):
    """The window form of kernel 1 and the ring decode of kernel 5 launch
    the kernel for CUDA tensors, as their plain forms do."""
    mod, wrapper, plains, n_args = DISPATCH[name]
    calls = []
    monkeypatch.setattr(mod, wrapper,
                        lambda *a, **k: calls.append(k) or "kernel")

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    for ref in plains:
        monkeypatch.setattr(mod, ref, plain)
    assert getattr(ops, name)(*[_FakeCuda() for _ in range(n_args)],
                              **kw) == "kernel"
    assert len(calls) == 1
    assert calls[0].get("window") == kw.get("window")   # passed through


@pytest.mark.parametrize("name", ["paged_decode_attention",
                                  "paged_decode_attention_lse"])
def test_dispatcher_passes_the_pinned_plan_to_the_kernel(monkeypatch, name):
    """A verify pass's ``plan_lanes`` reaches kernels 2 and 4 for CUDA
    tensors, and the plain versions (which have no splits) run without it
    on the CPU."""
    mod, wrapper, plains, n_args = DISPATCH[name]
    calls = []
    monkeypatch.setattr(mod, wrapper,
                        lambda *a, **k: calls.append(k) or "kernel")
    assert getattr(ops, name)(*[_FakeCuda() for _ in range(n_args)],
                              plan_lanes=4) == "kernel"
    assert calls == [{"scale": None, "plan_lanes": 4}]
    monkeypatch.setattr(mod, plains[0],
                        lambda *a, **k: calls.append(k) or "plain")
    cpu = [torch.zeros(1) for _ in range(n_args)]
    assert getattr(ops, name)(*cpu, plan_lanes=4) == "plain"
    assert calls[-1] == {"scale": None}


@pytest.mark.parametrize("window", [0, 16])
def test_dispatcher_sends_bidirectional_flash_to_the_kernel(monkeypatch,
                                                           window):
    """Kernel 1's bidirectional form (with and without a window) launches
    the kernel for CUDA tensors, its flags passed through."""
    calls = []
    monkeypatch.setattr(flash_mod, "flash_attention",
                        lambda *a, **k: calls.append(k) or "kernel")

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(flash_mod, "flash_attention_ref", plain)
    assert ops.flash_attention(*[_FakeCuda() for _ in range(3)],
                               causal=False, window=window) == "kernel"
    assert len(calls) == 1
    assert (calls[0]["causal"], calls[0]["window"]) == (False, window)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 5)])
def test_dispatcher_runs_bf16_flash_plain_on_cpu(causal, window):
    """bf16 CPU tensors (the kernel's tensor-core dtype) go to the plain
    version, and no launch is counted, ``tensor_core`` included."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 9, n, 16, generator=g).to(torch.bfloat16)
               .transpose(1, 2) for n in (4, 2, 2))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got, flash_mod.flash_attention_ref(
        q, k, v, causal=causal, window=window))
    assert got.dtype == torch.bfloat16
    assert (flash_mod.flash_attention.launches,
            flash_mod.flash_attention.tensor_core) == (0, 0)


# a mix of devices is refused; the meta device alone takes the plain path
# (test_dispatcher_takes_the_plain_path_on_meta)
@pytest.mark.parametrize("devices", [("cpu", "meta"), ("meta", "cpu")])
def test_dispatcher_refuses_other_devices(devices):
    q = torch.zeros(1, 2, 4, 8, device=devices[0])
    k = torch.zeros(1, 2, 4, 8, device=devices[1])
    i = torch.zeros(1, 2, dtype=torch.int32, device=devices[1])
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError):
        ops.paged_prefill_attention(q, k, k, i, i[:, 0])
    with pytest.raises(ValueError):
        ops.paged_verify_attention(q, k, k, i, i[:, 0])
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], k, k, i[:, 0])
    with pytest.raises(ValueError):
        ops.paged_decode_attention_lse(q[:, 0], k, k, i, i[:, 0], i)
    with pytest.raises(ValueError):
        ops.rwkv6_wkv(q, k, k, k, q[0, 0], None)
    with pytest.raises(ValueError):
        ops.int8_matmul(q[0, 0], k[0, 0].T, q[0, 0, :, :1], k[0, 0, :1])
    with pytest.raises(ValueError):
        ops.int8_matmul_quantized(q[0, 0], k[0, 0].T)


def test_dispatcher_takes_the_plain_path_on_meta():
    """Every kernel call on meta tensors alone runs its plain version
    (shapes only: nothing built, nothing launched), as ``launch.dryrun``
    and ``analysis`` trace steps there."""
    q = torch.zeros(1, 2, 4, 8, device="meta")
    i = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    outs = [ops.flash_attention(q, q, q),
            ops.paged_prefill_attention(q, q, q, i, i[:, 0]),
            ops.paged_verify_attention(q, q, q, i, i[:, 0]),
            ops.decode_attention(q[:, 0], q, q, i[:, 0]),
            ops.paged_decode_attention(q[:, 0], q, q, i, i[:, 0]),
            *ops.paged_decode_attention_lse(q[:, 0], q, q, i, i[:, 0], i),
            ops.int8_matmul_quantized(q[0, 0], q[0, 0].T),
            *ops.quantize_rows(q[0, 0]), *ops.quantize_cols(q[0, 0])]
    assert all(t.is_meta for t in outs)
    assert outs[0].shape == q.shape and outs[3].shape == q[:, 0].shape
    assert flash_mod.flash_attention.launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor is an error there, never
    a silent run of the plain version (and no count)."""
    q = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, q, q, causal=False)
    pool = torch.zeros(3, 8, 2, 32)
    tab = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_mod.paged_decode_attention(torch.zeros(1, 2, 32), pool, pool,
                                         tab, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        paged_mod.paged_decode_attention_lse(
            torch.zeros(1, 2, 32), pool, pool, tab,
            torch.zeros(1, dtype=torch.int32), torch.ones_like(tab))
    with pytest.raises(ValueError):
        prefill_mod.paged_prefill_attention(torch.zeros(1, 4, 2, 32), pool,
                                            pool, tab,
                                            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        prefill_mod.paged_prefill_attention_lse(
            torch.zeros(1, 4, 2, 32), pool, pool, tab,
            torch.zeros(1, dtype=torch.int32), torch.ones_like(tab))
    with pytest.raises(ValueError):
        dense_mod.decode_attention(torch.zeros(1, 2, 32),
                                   torch.zeros(1, 8, 2, 32),
                                   torch.zeros(1, 8, 2, 32),
                                   torch.zeros(1, dtype=torch.int32))
    r = torch.zeros(1, 3, 2, 32)
    with pytest.raises(ValueError):
        wkv_mod.rwkv6_wkv(r, r, r, r, torch.zeros(2, 32), None)
    xq = torch.zeros(4, 32, dtype=torch.int8)
    with pytest.raises(ValueError):
        i8_mod.int8_matmul(xq, xq.T.contiguous(), torch.ones(4, 1),
                           torch.ones(1, 4))
    with pytest.raises(ValueError):
        i8_mod.int8_matmul_quantized(torch.ones(4, 32), torch.ones(32, 4))
    assert flash_mod.flash_attention.launches == 0
    assert flash_mod.flash_attention.banded == 0
    assert flash_mod.flash_attention.bidirectional == 0
    assert flash_mod.flash_attention.tensor_core == 0
    assert prefill_mod.paged_prefill_attention.tensor_core == 0
    assert paged_mod.paged_decode_attention.launches == 0
    assert paged_mod.paged_decode_attention_lse.launches == 0
    assert prefill_mod.paged_prefill_attention.launches == 0
    assert prefill_mod.paged_prefill_attention_lse.launches == 0
    assert prefill_mod.paged_prefill_attention_lse.tensor_core == 0
    assert dense_mod.decode_attention.launches == 0
    assert wkv_mod.rwkv6_wkv.launches == 0
    assert i8_mod.int8_matmul.launches == 0


def test_model_runs_plain_versions_on_cpu_without_counting():
    m = Model(get_config("llama2-7b").smoke_config(), local_plan(),
              device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    logits, _ = m.prefill_ragged(p, torch.zeros(2, 16, dtype=torch.int32),
                                 torch.tensor([16, 3], dtype=torch.int32))
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()
    pool = m.init_paged_cache(5, 8)
    tables = torch.arange(1, 5, dtype=torch.int32).reshape(2, 2)
    logits, _ = m.prefill_chunk_paged(p, pool,
                                      torch.zeros(2, 8, dtype=torch.int32),
                                      torch.tensor([0, 4], dtype=torch.int32),
                                      torch.tensor([8, 3], dtype=torch.int32),
                                      tables)
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()
    logits, _ = m.decode_step(p, m.init_cache(2, 16, device="cpu"),
                              torch.zeros(2, dtype=torch.int32),
                              torch.tensor([3, 0], dtype=torch.int32))
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()
    sharded = Model(m.cfg, serving_plan(2), device="cpu")
    logits, _ = sharded.decode_step_paged(
        p, sharded.init_paged_cache(6, 8), torch.zeros(2, dtype=torch.int32),
        torch.tensor([3, 9], dtype=torch.int32),
        torch.tensor([[1, 4], [5, 2]], dtype=torch.int32))
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()
    logits, _ = sharded.prefill_chunk_paged(
        p, sharded.init_paged_cache(6, 8), torch.zeros(2, 8, dtype=torch.int32),
        torch.tensor([0, 4], dtype=torch.int32),
        torch.tensor([8, 3], dtype=torch.int32),
        torch.tensor([[1, 4], [5, 2]], dtype=torch.int32))
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()
    assert prefill_mod.paged_prefill_attention_lse.launches == 0
    assert flash_mod.flash_attention.launches == 0
    assert flash_mod.flash_attention.tensor_core == 0
    assert prefill_mod.paged_prefill_attention.tensor_core == 0
    assert prefill_mod.paged_prefill_attention.launches == 0
    assert dense_mod.decode_attention.launches == 0
    assert paged_mod.paged_decode_attention_lse.launches == 0


def test_rwkv_model_runs_plain_version_on_cpu_without_counting():
    m = Model(get_config("rwkv6-3b").smoke_config(), local_plan(),
              device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    logits, state = m.prefill(p, torch.zeros(1, 7, dtype=torch.int32))
    assert logits.shape == (1, 128) and torch.isfinite(logits).all()
    cache = m.init_cache(2, 16, device="cpu")
    logits, _ = m.decode_step(p, cache, torch.zeros(2, dtype=torch.int32),
                              torch.tensor([3, 0], dtype=torch.int32))
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()
    assert cache["tmix"]["wkv"].abs().sum() > 0     # written in place
    assert wkv_mod.rwkv6_wkv.launches == 0


def test_hybrid_model_runs_plain_versions_on_cpu_without_counting():
    """hymba's smoke model on the CPU: a prefill past the window (kernel
    1's window form) and a ring decode (kernel 5) through the plain
    versions, the Mamba state written in place, and no launch counted."""
    m = Model(get_config("hymba-1.5b").smoke_config(), local_plan(),
              device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    logits, cache = m.prefill(p, torch.zeros(1, 40, dtype=torch.int32))
    assert logits.shape == (1, 128) and torch.isfinite(logits).all()
    assert cache["attn"]["k"].shape[2] == 16             # the ring
    pool = m.init_cache(2, 64, device="cpu")
    logits, _ = m.decode_step(p, pool, torch.zeros(2, dtype=torch.int32),
                              torch.tensor([40, 0], dtype=torch.int32))
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()
    assert pool["mamba"]["ssm"].abs().sum() > 0          # written in place
    assert flash_mod.flash_attention.launches == 0
    assert flash_mod.flash_attention.banded == 0
    assert flash_mod.flash_attention.tensor_core == 0
    assert prefill_mod.paged_prefill_attention.tensor_core == 0
    assert dense_mod.decode_attention.launches == 0


def test_encoder_model_runs_plain_versions_on_cpu_without_counting():
    """hubert's smoke model on the CPU: frame embeddings through kernel
    1's bidirectional form in its plain version, per-frame logits and a
    prefill's cache, and no launch counted."""
    m = Model(get_config("hubert-xlarge").smoke_config(), local_plan(),
              device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    frames = torch.randn(2, 33, 64, generator=torch.Generator().manual_seed(1))
    logits = m.logits(p, frames)
    assert logits.shape == (2, 33, 128) and torch.isfinite(logits).all()
    last, cache = m.prefill(p, frames)
    assert torch.equal(last, logits[:, -1])
    assert cache["attn"]["k"].shape == (2, 2, 33, 2, 16)
    assert flash_mod.flash_attention.launches == 0
    assert flash_mod.flash_attention.bidirectional == 0
    assert flash_mod.flash_attention.tensor_core == 0
    assert prefill_mod.paged_prefill_attention.tensor_core == 0


@pytest.mark.parametrize("quantize", [False, True])
def test_moe_model_and_int8_ops_run_plain_on_cpu_without_counting(quantize):
    m = Model(get_config("granite-moe-3b-a800m").smoke_config(),
              local_plan(quantize_serve=quantize), device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    logits, _ = m.prefill_ragged(p, torch.zeros(2, 16, dtype=torch.int32),
                                 torch.tensor([16, 3], dtype=torch.int32))
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()
    logits, _ = m.decode_step_paged(
        p, m.init_paged_cache(5, 8), torch.zeros(2, dtype=torch.int32),
        torch.tensor([3, 9], dtype=torch.int32),
        torch.tensor([[1, 4], [3, 2]], dtype=torch.int32))
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()
    out = ops.int8_matmul_quantized(torch.randn(8, 64), torch.randn(64, 16))
    assert out.shape == (8, 16) and out.dtype == torch.bfloat16
    assert flash_mod.flash_attention.launches == 0
    assert paged_mod.paged_decode_attention.launches == 0
    assert i8_mod.int8_matmul.launches == 0
