"""LayerNorm as a plain XLA op.

The reference fused LayerNorm into a CUDA kernel with float4 loads and a
backward of two kernels on two streams (``src/layernorm_kernel.cu``: fw
``ker_layer_norm:36-98``, bw ``ker_ln_bw_dgamma_dbetta:192-259`` +
``ker_ln_bw_dinp:291-368``) because its baseline launched one kernel per op.
XLA fuses the normalisation, and its backward, with the neighbouring
residual adds and casts on its own; a custom call would block that fusion
of a bandwidth-bound op.  Statistics are taken in f32 whatever the input
dtype, as the fused kernel did.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def layernorm(x: Array, gamma: Array, beta: Array, eps: float = 1e-5) -> Array:
    """Layer normalisation over the last dim of ``x`` (any leading dims),
    with f32 statistics; returns ``x.dtype``.  Differentiable by JAX."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (y * gamma.astype(jnp.float32)
            + beta.astype(jnp.float32)).astype(x.dtype)


def layernorm_reference(x: Array, gamma: Array, beta: Array, eps: float = 1e-5) -> Array:
    """Pure-jnp oracle used by tests (the role torch plays in the reference)."""
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * gamma + beta
