"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on its
own by ``nvcc`` into ``_build/lib<name>-<hash>.so``, then loaded with
``ctypes``.  The hash covers the source and the flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built at import time:
``library(name)`` builds on first use, ``build_all()`` starts one ``nvcc``
per source in parallel.  ``_build/`` sits beside ``csrc/`` and is listed in
``.gitignore``.

``refuse_grad`` is every wrapper's guard: a kernel written into a tensor
through ctypes has no ``grad_fn``, so a wrapper called where autograd
would need one raises instead of cutting the gradient.  Kernels 1 and 7
train through their ``kernels.ops`` Functions, which call the wrappers
where no gradient is recorded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# streaming multiprocessors of the H100 SXM the sm_90a build targets: the
# number of CTAs the split plans (kernels 5, 6 and 7) fill
SMS = 132
SOURCES = ("flash_attention", "flash_attention_bwd", "paged_decode_attention",
           "paged_prefill_attention", "paged_prefill_attention_lse",
           "decode_attention", "rwkv6_wkv", "rwkv6_wkv_bwd", "int8_matmul")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when the library is current."""
    out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    """Wait for one build; returns the compiler's report (registers,
    shared memory, spills) and installs the library atomically."""
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source, one ``nvcc`` each, all at once.
    Returns ``{name: compiler report}`` (empty for reused libraries)."""
    jobs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, job) for name, job in jobs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = library(name).repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({msg})")


def refuse_grad(name: str, *tensors, hint: str = "") -> None:
    """Raise when grad mode is on and an input requires grad: ``name``
    has no backward, so its output would carry none.  Serving runs under
    ``torch.inference_mode`` / ``no_grad`` or on weights that need no
    grad and passes."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: this kernel has no backward, so its output would cut "
            f"the gradient"
            + (f"; {hint}" if hint else "")
            + ". Call it under torch.no_grad() or on inputs that do not "
              "require grad.")
