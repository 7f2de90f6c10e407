"""Gradient checking utilities.

The reference implements a full tape-based autodiff engine
(``minitorch/autodiff.py``: topological_sort:93, backpropagate:130) plus a
central-difference checker run against a float64 torch forward
(``tensor_functions.py:691-744``).  In JAX the engine itself *is*
``jax.grad`` / ``jax.vjp``; what remains worth owning is the checker, which
our kernel tests use exactly the way the reference's property tests use
``grad_check`` (tests/test_tensor_general.py).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def central_difference(f: Callable, *vals: Array, arg: int = 0, epsilon: float = 1e-6,
                       ind: tuple = ()) -> float:
    """Numerical derivative of ``f`` w.r.t. ``vals[arg][ind]``
    (reference autodiff.py:7-28 semantics, float64 for tightness)."""
    vals64 = [np.asarray(v, dtype=np.float64) for v in vals]
    up = [v.copy() for v in vals64]
    dn = [v.copy() for v in vals64]
    up[arg][ind] += epsilon
    dn[arg][ind] -= epsilon
    with jax.enable_x64():
        f_up = float(jnp.sum(f(*[jnp.asarray(v) for v in up])))
        f_dn = float(jnp.sum(f(*[jnp.asarray(v) for v in dn])))
    return (f_up - f_dn) / (2.0 * epsilon)


def grad_check(f: Callable, *vals: Array, n_samples: int = 10, tol: float = 1e-2,
               epsilon: float = 1e-6, rng: np.random.Generator | None = None) -> None:
    """Assert analytic grads (jax.grad) match central differences at random
    positions (reference tensor_functions.py:718-744 semantics)."""
    rng = rng or np.random.default_rng(0)

    def scalar_f(*xs):
        return jnp.sum(f(*xs))

    grads = jax.grad(scalar_f, argnums=tuple(range(len(vals))))(*vals)
    for _ in range(n_samples):
        arg = int(rng.integers(len(vals)))
        shape = vals[arg].shape
        ind = tuple(int(rng.integers(d)) for d in shape)
        analytic = float(grads[arg][ind])
        numeric = central_difference(f, *vals, arg=arg, epsilon=epsilon, ind=ind)
        np.testing.assert_allclose(
            analytic, numeric, rtol=tol, atol=tol,
            err_msg=f"grad mismatch at arg {arg} index {ind}",
        )
