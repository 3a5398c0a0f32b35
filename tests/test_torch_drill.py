"""``repro_torch.launch.drill`` against ``examples/failure_drill.py`` on the
CPU: the UPS and thermal (AHU) emergencies under Baseline and TAPAS
(paper Table 2).  Both run at a 6 h horizon (the example's ``run_drill``
monkeypatched to it, as ``test_torch_fleet.py`` shortens the sweep) and
the port prints exactly what the reference prints, run live."""
import torch_threads  # noqa: F401  (one torch thread a worker)

import pytest

jax = pytest.importorskip("jax")
from test_torch_fleet import _example  # noqa: E402

from repro.core import failures as JF  # noqa: E402
from repro_torch.launch import drill  # noqa: E402

HORIZON_H = 6.0


def test_launch_drill_prints_the_reference_table(capsys, monkeypatch):
    fd = _example("failure_drill")
    monkeypatch.setattr(fd, "run_drill", lambda *a, **kw: JF.run_drill(
        *a, **{**kw, "horizon_h": HORIZON_H}))
    fd.main()
    want = capsys.readouterr().out
    rows = drill.main(["--horizon-h", str(HORIZON_H), "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert [(r["failure"], r["policy"]) for r in rows] == [
        ("ups", "baseline"), ("ups", "place+route+config"),
        ("thermal", "baseline"), ("thermal", "place+route+config")]
