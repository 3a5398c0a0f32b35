"""Three AdamW steps of hymba-1.5b, minicpm3-4b and hubert-xlarge against
the reference's jitted ``make_train_step`` on the CPU, each on its
pipeline's batches (``next_batch``'s tokens, or for the encoder
``next_embed_batch``'s frames, equal to the reference's bit for bit).
rwkv6-3b's: test_torch_train_rwkv.py; ``launch/train.py`` and
``quickstart.py`` on the four families: test_torch_train_cli.py.

Smoke configs, weights carried over by ``from_jax_params``, f32 plans.
Tolerances, PR 27's, fixed before any result was read: each step's loss
within 1e-5 relative and its grad norm within 1e-4."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import local_plan as j_local_plan  # noqa: E402
from repro.training import data as JD  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model, local_plan  # noqa: E402
from repro_torch.training import data as TD  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402


def three_steps(arch):
    """Three train steps of ``arch``'s smoke config at batch 2 x 24 from
    the same weights and batches on both sides."""
    jm = j_build_model(j_get_config(arch).smoke_config(),
                       j_local_plan(param_dtype=jnp.float32,
                                    compute_dtype=jnp.float32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch).smoke_config(),
                     local_plan(param_dtype=torch.float32,
                                compute_dtype=torch.float32), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    jstep = jax.jit(JS.make_train_step(
        jm, JO.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=3)))
    tstep = TS.make_train_step(
        tm, TO.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=3))
    js, ts = JO.init_opt_state(jp), TO.init_opt_state(tp)
    jpipe = JD.TokenPipeline(JD.DataConfig(jm.cfg.vocab_size, 2, 24))
    tpipe = TD.TokenPipeline(TD.DataConfig(tm.cfg.vocab_size, 2, 24),
                             device="cpu")
    embeds = jm.cfg.input_kind == "embeds"
    for _ in range(3):
        if embeds:
            jb = jpipe.next_embed_batch(jm.cfg.d_model)
            tb = tpipe.next_embed_batch(tm.cfg.d_model)
        else:
            jb, tb = jpipe.next_batch(), tpipe.next_batch()
        jp, js, jmet = jstep(jp, js, *jb)
        tp, ts, tmet = tstep(tp, ts, *tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "minicpm3-4b",
                                  "hubert-xlarge"])
def test_three_train_steps_match_reference(arch):
    three_steps(arch)
