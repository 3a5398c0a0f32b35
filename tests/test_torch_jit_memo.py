"""One compiled reference per function: ``shared_jit``.

The JAX reference's ``Engine`` jits its model's methods when it is built
(``jax.jit(model.prefill_ragged)``, ...), and a new ``jax.jit`` wrapper
compiles afresh, so every reference engine a test builds over the same
model compiles the same programs again (~1-2 s each at smoke size). The
port's parity tests build many: importing ``shared_jit`` into a test
module makes ``jax.jit`` hand back one wrapper per (function, options)
for that module, so each program compiles once. The wrapper is the one
``jax.jit`` made; only the second compile of the same function is saved.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402


def memo_jit(real):
    """``jax.jit`` that returns one wrapper per (function, options);
    unhashable options (or functions) go to ``real`` every time."""
    memo = {}

    def jit(fun, *args, **kwargs):
        key = (fun, args, tuple(sorted(kwargs.items())))
        try:
            hit = memo.get(key)
        except TypeError:
            return real(fun, *args, **kwargs)
        if hit is None:
            hit = memo[key] = real(fun, *args, **kwargs)
        return hit

    jit.memo = memo
    return jit


@pytest.fixture(scope="module", autouse=True)
def shared_jit():
    """For the importing module: ``jax.jit`` memoized, then put back."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax, "jit", memo_jit(jax.jit))
        yield jax.jit


class _Model:
    def __init__(self, scale):
        self.scale = scale

    def apply(self, x):
        return x * self.scale


def test_memo_jit_shares_a_wrapper_per_function_and_options(shared_jit):
    a, b = _Model(2.0), _Model(3.0)
    f1, f2 = jax.jit(a.apply), jax.jit(a.apply)
    assert f1 is f2
    assert jax.jit(b.apply) is not f1
    assert jax.jit(a.apply, donate_argnums=(0,)) is not f1
    x = jnp.arange(4.0)
    assert jnp.array_equal(f1(x), x * 2) and jnp.array_equal(
        jax.jit(b.apply)(x), x * 3)
    # a function whose options cannot be hashed gets its own wrapper
    assert jax.jit(a.apply, static_argnames=["x"]) is not \
        jax.jit(a.apply, static_argnames=["x"])
