"""Shared helpers for the Pallas kernel tier."""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Big-but-finite mask value: -inf produces NaNs in exp(-inf - (-inf)) during
# online-softmax rescaling (the reference uses -1e8 / -float_max).
DEFAULT_MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


def use_interpret_mode() -> bool:
    """Run Pallas kernels through the interpreter on the CPU, and only there.

    The reference gates CUDA tests on ``numba.cuda.is_available()``
    (tests/test_flash_attention.py:16-21).  Here the same kernel code is
    compiled through Triton on a GPU and interpreted on the CPU, where the
    tests run; no other backend takes a Pallas route.
    """
    return jax.default_backend() == "cpu"


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
