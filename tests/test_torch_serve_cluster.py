"""``repro_torch.launch.serve_cluster`` against ``examples/serve_cluster.py``
on the CPU: four smoke llama2-7b engines under ``TapasRouter`` and the
thermal model (the paper's Fig. 17 loop).  The port's run prints exactly
what the reference example prints, run live: every tick's outside
temperature, risk, load and requests served, and the closing line."""
import torch_threads  # noqa: F401  (one torch thread a worker)

import pytest

jax = pytest.importorskip("jax")
from test_torch_fleet import _example  # noqa: E402

from repro_torch.launch import serve_cluster  # noqa: E402


def test_launch_serve_cluster_prints_the_reference_example(capsys):
    _example("serve_cluster").main()
    want = capsys.readouterr().out
    got = serve_cluster.main(["--smoke", "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert len(want.splitlines()) == 11
    engines = got["engines"]
    assert len(engines) == serve_cluster.N_VMS
    assert got["total"] == sum(len(e.stats.completed) for e in engines) > 0
    # one weight copy between the engines, the small variant's included
    for name in ("full", "small"):
        assert all(e.variants[name][1] is engines[0].variants[name][1]
                   for e in engines)
    small = engines[0].variants["small"][0].cfg
    assert (small.num_layers, small.d_ff, small.name) == \
        (1, 64, "llama2-smaller")
    assert engines[0].model.device.type == "cpu"
