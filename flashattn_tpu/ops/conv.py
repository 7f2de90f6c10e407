"""conv1d / conv2d.

JAX equivalent of reference ``minitorch/fast_conv.py`` (numba-jitted
``_tensor_conv1d:27`` / ``_tensor_conv2d`` + ``Conv1dFun``/``Conv2dFun``).
Semantics match the reference: correlation (no kernel flip), output the same
spatial size as the input, kernel anchored at each position extending right/
down, zero-padded past the edge.

Implementation is ``lax.conv_general_dilated`` -- XLA lowers it to cuDNN or
an implicit GEMM; autodiff comes from jax (the reference hand-writes the
transposed conv in its backward).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def conv1d(input: Array, weight: Array) -> Array:
    """input (batch, in_ch, w), weight (out_ch, in_ch, kw) -> (batch, out_ch, w)."""
    kw = weight.shape[-1]
    return jax.lax.conv_general_dilated(
        input, weight,
        window_strides=(1,),
        padding=[(0, kw - 1)],
        dimension_numbers=("NCH", "OIH", "NCH"),
    )


def conv2d(input: Array, weight: Array) -> Array:
    """input (batch, in_ch, h, w), weight (out_ch, in_ch, kh, kw) ->
    (batch, out_ch, h, w)."""
    kh, kw = weight.shape[-2:]
    return jax.lax.conv_general_dilated(
        input, weight,
        window_strides=(1, 1),
        padding=[(0, kh - 1), (0, kw - 1)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
