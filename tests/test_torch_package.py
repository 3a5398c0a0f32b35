"""Package rules of the port: it never imports JAX or the JAX package, its
entry points default to CUDA, and the kernel dispatcher never hands a CUDA
tensor to a plain version."""
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
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import paged_decode_attention as paged_mod
from repro_torch.models import Model, build_model, layers, local_plan
from repro_torch.models import attention as TA

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(repro_torch.__file__).resolve().parent


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
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
    assert not flash_mod._kernel.cache_info().currsize
    assert not paged_mod._kernel.cache_info().currsize


@pytest.mark.parametrize("fn", [
    build_model, Model.__init__, convert.from_jax_params, layers.dense_init,
    layers.embed_init, layers.rope_freqs, layers.mlp_init, TA.init_gqa,
    TA.kv_index, TA.init_paged_attn_cache,
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


class _FakeCuda:
    """Stands in for a CUDA tensor where there is no card: the dispatcher
    routes on ``.device`` alone."""
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("name,n_args", [("flash_attention", 3),
                                         ("paged_decode_attention", 5)])
def test_dispatcher_sends_cuda_tensors_to_the_kernel(monkeypatch, name,
                                                     n_args):
    mod = flash_mod if name == "flash_attention" else paged_mod
    calls = []
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(a) or "kernel")

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(mod, f"{name}_ref", plain)
    args = [_FakeCuda() for _ in range(n_args)]
    assert getattr(ops, name)(*args) == "kernel"
    assert len(calls) == 1


@pytest.mark.parametrize("devices", [("cpu", "meta"), ("meta", "meta")])
def test_dispatcher_refuses_other_devices(devices):
    q = torch.zeros(1, 2, 4, 8, device=devices[0])
    k = torch.zeros(1, 2, 4, 8, device=devices[1])
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor is an error there, never
    a silent run of the plain version (and no count)."""
    q = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q, q, q)
    pool = torch.zeros(3, 8, 2, 32)
    tab = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_mod.paged_decode_attention(torch.zeros(1, 2, 32), pool, pool,
                                         tab, torch.zeros(1, dtype=torch.int32))
    assert flash_mod.flash_attention.launches == 0
    assert paged_mod.paged_decode_attention.launches == 0


def test_model_runs_plain_versions_on_cpu_without_counting():
    m = Model(get_config("llama2-7b").smoke_config(), local_plan(),
              device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    logits, _ = m.prefill_ragged(p, torch.zeros(2, 16, dtype=torch.int32),
                                 torch.tensor([16, 3], dtype=torch.int32))
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()
    assert flash_mod.flash_attention.launches == 0
