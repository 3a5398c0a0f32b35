"""``launch/train.py --smoke`` on the CPU for each of the four families
that once refused training (rwkv6-3b, hymba-1.5b, minicpm3-4b, and
hubert-xlarge on ``next_embed_batch``'s frame embeddings, as the
reference's driver chooses by ``input_kind``), and ``launch/quickstart.py``
on the encoder, which trains and is not served, as in the reference.
Finite losses; the printed step lines."""
import numpy as np
import pytest

from repro_torch.launch import quickstart
from repro_torch.launch import train as t_train


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b", "minicpm3-4b",
                                  "hubert-xlarge"])
def test_train_cli_smoke(arch, capsys):
    out = t_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "24"])
    text = capsys.readouterr().out
    assert "step    2 loss" in text
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_quickstart_trains_the_encoder_and_serves_nothing(capsys):
    out = quickstart.main("hubert-xlarge", device="cpu")
    assert len(out["losses"]) == 10 and all(map(np.isfinite, out["losses"]))
    assert out["completed"] == 0
    assert "encoder-only arch: no decode; done." in capsys.readouterr().out
