"""rwkv6-3b trains against the live JAX reference on the CPU: ``Model.loss``
and every grad leaf (kernel 7's gradient through ``ops.WkvFn``, its plain
training form and backward on CPU tensors) against ``jax.value_and_grad``
of the reference ``Model.loss``, and three AdamW steps against the
reference's jitted ``make_train_step``.

Smoke config, weights carried over by ``from_jax_params``, f32 plans.
Tolerances, PR 27's, fixed before any result was read: the loss within
1e-5 relative and each grad leaf within 1e-4 of its own max |g|; the
three steps' losses within 1e-5 relative and their grad norms within
1e-4."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

pytest.importorskip("jax")

from test_torch_train_families import held_to_reference  # noqa: E402
from test_torch_train_families_step import three_steps  # noqa: E402


def test_loss_and_grads_match_reference():
    held_to_reference("rwkv6-3b")


def test_three_train_steps_match_reference():
    three_steps("rwkv6-3b")
