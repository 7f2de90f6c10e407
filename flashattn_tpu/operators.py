"""Scalar math prelude + higher-order map/zipWith/reduce.

JAX re-design of the reference's L0 layer (minitorch ``operators.py``,
see reference ``minitorch/operators.py:12-255``).  In the reference these pure-
Python scalar functions are the atoms that every backend (SimpleOps / FastOps /
CudaOps / CudaKernelOps) JIT-compiles or dispatches on via an ``fn_id`` table.

Under JAX the whole dispatch tier collapses: these are ordinary ``jnp``
functions that XLA traces, fuses and vectorises.  They exist (a) as the
shared vocabulary for the functional nn layer, (b) so property tests can run
the same op-table-driven strategy the reference uses
(``minitorch/testing.py``), and (c) to document the 1:1 parity mapping.

Every function operates elementwise on scalars or arrays.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import jax
import jax.numpy as jnp

Array = jax.Array

# ---------------------------------------------------------------------------
# Elementwise ops (reference operators.py:12-146)
# ---------------------------------------------------------------------------


def mul(x, y):
    ":math:`f(x, y) = x * y`"
    return x * y


def id(x):  # noqa: A001 - parity with reference name
    ":math:`f(x) = x`"
    return x


def add(x, y):
    ":math:`f(x, y) = x + y`"
    return x + y


def neg(x):
    ":math:`f(x) = -x`"
    return -x


def lt(x, y):
    ":math:`f(x) = 1.0 if x < y else 0.0`"
    return jnp.asarray(x < y, dtype=jnp.result_type(x, y, jnp.float32))


def eq(x, y):
    ":math:`f(x) = 1.0 if x == y else 0.0`"
    return jnp.asarray(x == y, dtype=jnp.result_type(x, y, jnp.float32))


def max(x, y):  # noqa: A001
    ":math:`f(x, y) = max(x, y)`"
    return jnp.maximum(x, y)


def is_close(x, y, tol: float = 1e-2):
    ":math:`f(x) = |x - y| < tol`"
    return jnp.asarray(jnp.abs(x - y) < tol, dtype=jnp.float32)


def sigmoid(x):
    r""":math:`f(x) = \frac{1}{1 + e^{-x}}` (numerically stable form)."""
    return jax.nn.sigmoid(x)


def sigmoid_back(x, d):
    "Derivative of sigmoid times d."
    s = jax.nn.sigmoid(x)
    return s * (1.0 - s) * d


def relu(x):
    ":math:`f(x) = max(0, x)`"
    return jnp.maximum(x, 0)


def log(x):
    ":math:`f(x) = log(x)`"
    return jnp.log(x)


def exp(x):
    ":math:`f(x) = e^{x}`"
    return jnp.exp(x)


def log_back(x, d):
    r"If :math:`f = log` as above, compute :math:`d \times f'(x)`."
    return d / x


def inv(x):
    ":math:`f(x) = 1/x`"
    return 1.0 / x


def inv_back(x, d):
    r"If :math:`f(x) = 1/x`, compute :math:`d \times f'(x)`."
    return -d / (x * x)


def relu_back(x, d):
    r"If :math:`f = relu`, compute :math:`d \times f'(x)`."
    return jnp.where(x > 0, d, jnp.zeros_like(d))


def sigmoid_prime(x):
    s = jax.nn.sigmoid(x)
    return s * (1.0 - s)


def pow(base, exponent):  # noqa: A001
    ":math:`f(x) = base ** exponent`"
    return base**exponent


def tanh(x):
    ":math:`f(x) = tanh(x)`"
    return jnp.tanh(x)


EPS = 1e-6


# ---------------------------------------------------------------------------
# Higher-order functions (reference operators.py:153-255).
#
# The reference hand-rolls map/zipWith/reduce over python lists and later
# re-implements them as strided CUDA kernels (combine.cu:385-580).  Here they
# are thin wrappers over jnp broadcasting -- under jit XLA fuses them away,
# which *is* the replacement for that whole kernel family.
# ---------------------------------------------------------------------------


def map(fn: Callable) -> Callable:  # noqa: A001
    "Higher-order map: apply ``fn`` to each element of an array or iterable."

    def _map(xs):
        if isinstance(xs, (jnp.ndarray, jax.Array)):
            return fn(xs)
        return [fn(x) for x in xs]

    return _map


def zipWith(fn: Callable) -> Callable:
    "Higher-order zipWith: combine elements of two arrays with ``fn``."

    def _zip(xs, ys):
        if isinstance(xs, (jnp.ndarray, jax.Array)):
            return fn(xs, ys)
        return [fn(x, y) for x, y in zip(xs, ys)]

    return _zip


def reduce(fn: Callable, start: float) -> Callable:
    "Higher-order reduce with initial value ``start``."

    def _reduce(xs):
        if isinstance(xs, (jnp.ndarray, jax.Array)):
            flat = xs.reshape(-1)
            return jax.lax.reduce(flat, jnp.asarray(start, flat.dtype), fn, (0,))
        val = start
        for x in xs:
            val = fn(val, x)
        return val

    return _reduce


def negList(ls: Iterable) -> list:
    "Negate each element of a list."
    return map(neg)(list(ls))


def addLists(ls1: Iterable, ls2: Iterable) -> list:
    "Pairwise addition of two lists."
    return zipWith(add)(list(ls1), list(ls2))


def sum(ls) -> float:  # noqa: A001
    "Sum of a list/array."
    return reduce(add, 0.0)(ls)


def prod(ls) -> float:
    "Product of a list/array."
    if isinstance(ls, (jnp.ndarray, jax.Array)):
        return reduce(mul, 1.0)(ls)
    out = 1.0
    for x in ls:
        out = out * x
    return out
