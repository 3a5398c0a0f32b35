"""tapaslint for the port (``repro_torch.analysis.lint``) against the
reference's (``repro.analysis.lint``), run live.

* The rules that carry over (TL001's reference checks, TL004-TL007) and
  the framework (suppression, baseline, keys, TL000): every case of
  ``tests/test_tapaslint.py`` runs against the reference as written, and
  the same sources with ``src/repro/`` mapped to ``src/repro_torch/`` give
  the port the same findings.
* The rules reworked for captured CUDA-graph steps (TL001's torch draws,
  TL002, TL003, TL008): a flagged, a quiet and a suppressed case each;
  the quiet cases include ``kernels/ops.py``'s device branch and a
  ``.cpu()`` outside any capture.
* The CLI (``python -m repro_torch.analysis.lint``), the package's
  imports (neither torch nor numpy nor the reference), and two whole-tree
  lanes: the port's default paths against its empty baseline and the
  reference's lint over ``src benchmarks examples scripts``, both clean.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import test_tapaslint as ref_cases
from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint as port_lint
from repro_torch.analysis.lint import __main__ as cli

ROOT = Path(__file__).resolve().parent.parent
SERVING = "src/repro_torch/serving/mod.py"
MODELS = "src/repro_torch/models/mod.py"
KERNELS = "src/repro_torch/kernels/mod.py"
CORE = "src/repro_torch/core/mod.py"


def _port_path(path: str) -> str:
    return "src/repro_torch/" + path[len("src/repro/"):] \
        if path.startswith("src/repro/") else path


def _fields(f, path=lambda p: p) -> tuple:
    return (f.rule, path(f.path), f.line, f.message, f.symbol)


# ---------------------------------------------------------------------------
# the reference's cases, run live against both packages
# ---------------------------------------------------------------------------

CARRIED = sorted(
    name for name, fn in vars(ref_cases).items()
    if inspect.isfunction(fn) and name.startswith(
        ("test_tl001_", "test_tl004_", "test_tl005_", "test_tl006_",
         "test_tl007_", "test_syntax_", "test_baseline_", "test_finding_")))


def test_carried_cases_cover_the_reference_file():
    assert len(CARRIED) == 24
    assert not [n for n in vars(ref_cases) if n.startswith("test_")
                and n not in CARRIED
                and not n.startswith(("test_tl002_", "test_tl003_",
                                      "test_tl008_"))]


@pytest.mark.parametrize("name", CARRIED)
def test_port_gives_the_reference_findings(name, monkeypatch):
    """Run the reference's case as written (its asserts hold the
    reference), recording every source set it lints; each set, mapped to
    the port's paths, gives the port the same findings, keys and baseline
    diff."""
    calls = []

    def recording(files, rules=None):
        found = ref_lint.lint_sources(files, rules)
        calls.append((files, found))
        return found

    monkeypatch.setattr(ref_cases, "lint_sources", recording)
    getattr(ref_cases, name)()
    assert calls
    for files, want in calls:
        got = port_lint.lint_sources({_port_path(p): s
                                      for p, s in files.items()})
        assert [_fields(f) for f in got] == \
            [_fields(f, _port_path) for f in want]
        keys = [f.key() for f in got]
        assert len(set(keys)) == len(set(f.key() for f in want))
        new, matched, stale = port_lint.diff_baseline(got, keys + ["x"])
        assert (new, matched, stale) == ([], keys, ["x"])


# ---------------------------------------------------------------------------
# the reworked rules
# ---------------------------------------------------------------------------

def run(files):
    if isinstance(files, str):
        files = {"src/repro_torch/anywhere.py": files}
    return port_lint.lint_sources({p: textwrap.dedent(s)
                                   for p, s in files.items()})


def codes(files):
    return [f.rule for f in run(files)]


def test_tl001_flags_torch_global_rng():
    fs = """\
    import torch

    def draw(x):
        torch.manual_seed(0)
        a = torch.randn(3)
        b = torch.randint(0, 9, (2,))
        c = torch.rand_like(x)
        x.normal_()
        return a, b, c
    """
    fnd = run(fs)
    assert [f.rule for f in fnd] == ["TL001"] * 5
    assert "torch.manual_seed()" in fnd[0].message
    assert "torch.randn() without generator=" in fnd[1].message
    assert ".normal_() without generator=" in fnd[4].message


def test_tl001_quiet_on_explicit_generators():
    fs = """\
    import torch

    def draw(x, seed):
        gen = torch.Generator(device=x.device).manual_seed(seed)
        a = torch.randn(3, generator=gen)
        b = torch.randint(0, 9, (2,),
                          generator=gen)
        x.uniform_(generator=gen)
        return a, b, torch.Generator().manual_seed(1)
    """
    assert codes(fs) == []


def test_tl001_torch_suppression():
    fs = """\
    import torch

    def bench():
        return torch.randn(3)  # tapaslint: disable=TL001 timing input only
    """
    assert codes(fs) == []


def test_captured_functions_follow_program_graph_blocks_and_names():
    src = textwrap.dedent("""\
    import torch

    def horizon_program(model, bufs):
        def body():
            def inner():
                pass
        return Program("h", body, bufs, None, capture=True)

    def replay_once(g):
        with torch.cuda.graph(g):
            step()

    def step():
        pass

    def decode_step_paged(x):
        pass

    def host_pump(x):
        pass
    """)
    ctx = port_lint.ModuleContext(SERVING, src, port_lint.Registry())
    names = sorted(f.name for f in ctx.captured_functions)
    assert names == ["body", "decode_step_paged", "inner", "step"]


def test_tl002_flags_host_syncs_inside_captured_bodies():
    fs = {SERVING: """\
    import numpy as np
    import torch

    def horizon_program(model, bufs):
        def body():
            x = bufs["nxt"]
            a = x.cpu()
            b = x.numpy()
            c = x.to("cpu")
            n = float(x)
            h = np.asarray(x)
            torch.cuda.synchronize()
            i = torch.nonzero(x)
            j = x.nonzero()
            return a, b, c, n, h, i, j
        return Program("h", body, bufs, None, capture=True)
    """}
    fnd = run(fs)
    assert [f.rule for f in fnd] == ["TL002"] * 8
    assert ".cpu() inside a captured function" in fnd[0].message
    assert "torch.cuda.synchronize()" in fnd[5].message
    assert all(f.symbol.endswith("body") for f in fnd)


def test_tl002_flags_item_anywhere_in_scope_and_only_there():
    fs = {SERVING: """\
    def schedule(scores):
        return scores[0].item(), scores.tolist()
    """, CORE: """\
    def report(x):
        return x.item()
    """}
    fnd = run(fs)
    assert [(f.rule, f.path) for f in fnd] == [("TL002", SERVING)] * 2


def test_tl002_quiet_outside_captures():
    # the engine's per-horizon readback and staging: host-side code
    fs = {SERVING: """\
    import numpy as np
    import torch

    def drain(toks, dev):
        host = toks.cpu().numpy()
        torch.cuda.synchronize()
        return host, np.asarray(dev.to("cpu")), int(host[0])
    """}
    assert codes(fs) == []


def test_tl002_suppression():
    fs = {MODELS: """\
    def decode_step(params, x):
        return x.cpu()  # tapaslint: disable=TL002 probe, never captured
    """}
    assert codes(fs) == []


def test_tl003_flags_runtime_branch_inside_capture():
    fs = {MODELS: """\
    def decode_step(params, x, positions):
        if positions.max() > 0:
            x = x + 1
        while x.sum() > 0:
            x = x - 1
        return x
    """}
    fnd = run(fs)
    assert [f.rule for f in fnd] == ["TL003", "TL003"]
    assert "'positions'" in fnd[0].message and "`while`" in fnd[1].message


def test_tl003_quiet_on_device_and_static_probes():
    fs = {KERNELS: """\
    def decode_attention(q, k, v, positions, *, ring: bool = False):
        if q.device.type == "cpu":
            return q
        if q.device.type == "cuda" and k.is_cuda:
            q = q + 1
        if q.shape[0] > 1 and v is not None and ring:
            q = q * 2
        return q
    """}
    assert codes(fs) == []


def test_tl003_quiet_on_the_ops_device_branch():
    """``kernels/ops.py`` has no device branch: each kernel is a
    ``torch.library`` op whose route the dispatcher picks, and its one
    Python branch, kernel 5's plain version by ``ring``, reads a bool
    fixed for the life of a capture.  A branch on a helper's verdict
    about a tensor is a runtime branch to TL003."""
    path = "src/repro_torch/kernels/ops.py"
    src = (ROOT / path).read_text()
    assert "def _dense_cpu(q, k, v, positions, *, scale=None, " \
        "ring: bool = False):" in src
    assert "_LIB.impl(name, _refusing(name, cuda, hint), \"CUDA\")" in src
    assert [f for f in port_lint.lint_sources({path: src})
            if f.rule == "TL003"] == []
    fs = {KERNELS: """\
    def decode_attention(q, k, v, positions):
        if _on_cpu(q, k, v, positions):
            return q
        return k
    """}
    assert codes(fs) == ["TL003"]


def test_tl003_flags_computed_program_keys():
    fs = {SERVING: """\
    class Engine:
        def decode(self, prog, n, left):
            p = G.horizon_program(self.model, self.t, min(n, 4), self.width)
            q = G.chunk_program(self.model, self.t, rows=n + 1, chunk=16,
                                width=self.width)
            return G.run_horizon(prog, len(left)), p, q
    """}
    fnd = run(fs)
    assert [f.rule for f in fnd] == ["TL003"] * 3
    assert "lanes=" in fnd[0].message and "rows=" in fnd[1].message
    assert "num_steps=" in fnd[2].message


def test_tl003_quiet_on_stable_program_keys():
    fs = {SERVING: """\
    class Engine:
        def decode(self, prog, n_eff, width):
            p = G.horizon_program(self.model, self.t, width, self.T,
                                  max_len=self.max_seq + 1, sampled=True)
            return G.run_horizon(prog, n_eff), G.run_spec(prog, 4), p
    """}
    assert codes(fs) == []


def test_tl003_suppression():
    fs = {MODELS: """\
    def prefill_ragged(params, tokens, lengths):
        if lengths.numel() and tokens.sum():  # tapaslint: disable=TL003 eager
            return tokens
        return lengths
    """}
    assert codes(fs) == []


def test_tl008_flags_host_construction_inside_capture():
    fs = {MODELS: """\
    import numpy as np
    import torch

    FREQS = np.linspace(0.0, 1.0, 8)
    WARP = [1.0, 0.5]

    def decode_step(params, x):
        idx = torch.tensor([0, 1], device=x.device)
        m = torch.as_tensor(np.arange(4))
        return x * FREQS + WARP[0] + idx + m + torch.from_numpy(params)
    """}
    fnd = run(fs)
    assert [f.rule for f in fnd] == ["TL008"] * 6
    msgs = " ".join(f.message for f in fnd)
    for part in ("torch.tensor(", "torch.as_tensor(", "np.arange(",
                 "torch.from_numpy(", "'FREQS'", "'WARP'"):
        assert part in msgs


def test_tl008_quiet_on_device_construction_and_host_code():
    fs = {SERVING: """\
    import numpy as np
    import torch

    TABLE = np.zeros(8)

    def decode_step(params, x):
        return x + torch.arange(x.shape[-1], device=x.device)

    def host_pump(reqs):
        lanes = torch.tensor(np.zeros(len(reqs), np.int32))
        return lanes, TABLE
    """, CORE: """\
    import torch

    def decode_blend(x):
        return x * torch.tensor([0.5])     # core/ is out of TL008 scope
    """}
    assert codes(fs) == []


def test_tl008_suppression():
    fs = {KERNELS: """\
    import torch

    def _paged_table(x):  # tapaslint: disable=TL008 built once per shape
        return torch.tensor([1, 2], device=x.device)
    """}
    assert codes(fs) == []


def test_tl007_covers_kernels_and_chip_smoke():
    body = """\
    def build_or_plain(name):
        try:
            return load(name)
        except Exception:
            pass
    """
    fs = {KERNELS: body, "chip_smoke.py": body, MODELS: body}
    assert [(f.rule, f.path) for f in run(fs)] == [
        ("TL007", "chip_smoke.py"), ("TL007", KERNELS)]


def test_rules_are_the_eight_in_code_order():
    assert [r.code for r in port_lint.ALL_RULES] == \
        [f"TL00{i}" for i in range(1, 9)]
    assert [r.name for r in port_lint.ALL_RULES if r.code in (
        "TL004", "TL005", "TL006", "TL007")] == [
        r.name for r in ref_lint.ALL_RULES if r.code in (
            "TL004", "TL005", "TL006", "TL007")]
    assert all(r.scopes == ("",) or all(
        s.startswith(("src/repro_torch/", "chip_smoke.py"))
        for s in r.scopes) for r in port_lint.ALL_RULES)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_lists_and_explains_rules(capsys):
    assert cli.main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == \
        [f"TL00{i}" for i in range(1, 9)]
    assert cli.main(["--explain", "tl003"]) == 0
    assert "capture hazard" in capsys.readouterr().out
    assert cli.main(["--explain", "TL999"]) == 2


def _tree(root: Path, source: str) -> None:
    path = root / "src" / "repro_torch" / "serving" / "mod.py"
    path.parent.mkdir(parents=True)
    path.write_text(textwrap.dedent(source))


def test_cli_exit_codes_and_baseline(tmp_path, monkeypatch, capsys):
    _tree(tmp_path, """\
    def schedule(scores):
        return scores[0].item()
    """)
    monkeypatch.setattr(cli, "ROOT", tmp_path)
    base = tmp_path / "baseline.txt"
    assert cli.main(["--baseline", str(base)]) == 1
    assert "TL002" in capsys.readouterr().out
    assert cli.main(["--baseline", str(base), "--update-baseline"]) == 0
    assert "1 grandfathered" in capsys.readouterr().out
    assert port_lint.load_baseline(base) == [
        "TL002 src/repro_torch/serving/mod.py::schedule .item() forces a "
        "device->host sync per element; batch the readback (one "
        "np.asarray per horizon) and count it in stats.host_syncs"]
    assert cli.main(["--baseline", str(base)]) == 0
    assert cli.main(["--baseline", str(base), "--no-baseline"]) == 1
    assert cli.main(["--baseline", str(base), "--fail-on-baseline"]) == 1
    assert "baseline is not empty" in capsys.readouterr().out


def test_cli_update_baseline_writes_an_empty_one_on_a_clean_tree(tmp_path):
    base = tmp_path / "baseline.txt"
    assert cli.main(["--baseline", str(base), "--update-baseline"]) == 0
    assert port_lint.load_baseline(base) == []
    assert base.read_text() == port_lint.format_baseline([])


def test_lint_package_imports_neither_torch_numpy_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.analysis.lint\n"
            "from repro_torch.analysis.lint import __main__\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'repro', 'jax')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# the whole tree
# ---------------------------------------------------------------------------

def test_port_lint_is_clean_on_its_default_paths(capsys):
    """``python -m repro_torch.analysis.lint --fail-on-baseline``: the
    port, ``chip_smoke.py`` and the port's scripts, against the empty
    baseline."""
    assert port_lint.load_baseline(cli.DEFAULT_BASELINE) == []
    assert cli.main(["--fail-on-baseline"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out
    files = port_lint.collect_files(ROOT, cli.DEFAULT_PATHS)
    assert "chip_smoke.py" in files and "scripts/flash_turns.py" in files
    assert "src/repro_torch/serving/engine.py" in files


def test_reference_lint_is_clean_on_the_whole_tree():
    """The repo's CI lint lane (``scripts/tapaslint.py --fail-on-baseline``
    over ``src benchmarks examples scripts``), which lints the port too."""
    files = ref_lint.collect_files(ROOT, ["src", "benchmarks", "examples",
                                          "scripts"])
    assert "src/repro_torch/serving/backend.py" in files
    assert ref_lint.lint_sources(files) == []
    assert ref_lint.load_baseline(ROOT / "scripts"
                                  / "tapaslint_baseline.txt") == []
