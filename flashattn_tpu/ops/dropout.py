"""Dropout fused with bias, residual and activation, as plain XLA ops.

The reference declares LightSeq dropout launchers
(``launch_ls_dropout_res_bias`` / ``launch_ls_dropout_act_bias``,
src/includes/kernels.h:113-175) that compute bias add, mask, inverted
rescale and residual add in one pass.  Here each op is the same composition
in ``jax.numpy`` over a ``jax.random`` keep mask; XLA fuses the elementwise
chain into one kernel per op on the GPU.  A counter-based generator inside
a kernel would also drop the separate mask pass; it is worth writing only if
a trace shows dropout on the hot path.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

Array = jax.Array

_GELU_C = math.sqrt(2.0 / math.pi)


def _dropout(y: Array, rate: float, key: jax.Array | None) -> Array:
    if rate <= 0.0 or key is None:
        return y
    keep = jax.random.bernoulli(key, 1.0 - rate, y.shape)
    return jnp.where(keep, y, jnp.zeros_like(y)) / (1.0 - rate)


def fused_dropout(x: Array, rate: float, key: jax.Array | None) -> Array:
    """Inverted dropout: the same bernoulli mask from the same key as
    ``nn.functional.dropout(scale=True)``."""
    return _dropout(x, rate, key)


def fused_dropout_res_bias(x: Array, bias: Array, residual: Array,
                           rate: float, key: jax.Array | None) -> Array:
    """residual + dropout(x + bias) (kernels.h:118-122)."""
    return residual + _dropout(x + bias, rate, key)


def fused_dropout_act_bias(x: Array, bias: Array, rate: float,
                           key: jax.Array | None, act: str = "gelu") -> Array:
    """dropout(act(x + bias)) (kernels.h:123-126)."""
    if act not in ("gelu", "relu"):
        raise ValueError(f"act must be 'gelu' or 'relu', got {act!r}")
    u = x + bias
    if act == "gelu":
        y = 0.5 * u * (1.0 + jnp.tanh(_GELU_C * (u + 0.044715 * u**3)))
    else:
        y = jnp.maximum(u, 0.0)
    return _dropout(y, rate, key)
