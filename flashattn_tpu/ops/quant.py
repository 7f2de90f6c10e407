"""Quantization: int8 / fp8 tensors and the weight-only matmul.

The reference only *declares* a quantized surface (unimplemented lightseq
prototypes ``launch_layer_norm_i8`` etc., src/includes/kernels.h:30,101-175,
and test helpers test_utils.py:71-88).  Here it is real and plain JAX:

* symmetric per-channel (absmax/127 or absmax/448) scales kept in f32;
* weight-only matmuls convert the int8/fp8 payload to the activation dtype
  inside the product, which XLA fuses into the GEMM's operand load, so the
  weight is read from device memory at one byte per element;
* quantised KV pages are read by the paged decode kernel
  (``ops/paged_attention.py``), which applies the per-token scales after
  its dots.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class QuantizedTensor(NamedTuple):
    """int8 payload + broadcastable f32 scales (values ~= payload * scales)."""

    values: Array  # int8
    scales: Array  # f32, broadcastable against values

    @property
    def shape(self):
        return self.values.shape

    def dequantize(self, dtype=jnp.float32) -> Array:
        return self.values.astype(dtype) * self.scales.astype(dtype)


def quantize_int8(x: Array, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-channel int8 quantisation (absmax / 127) along ``axis``.

    Plain jnp -- XLA fuses the absmax+scale+round chain; see
    :func:`quantize_int8_stochastic` for unbiased rounding.
    """
    absmax = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    scale = jnp.where(absmax == 0, 1.0, absmax / 127.0).astype(jnp.float32)
    q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return QuantizedTensor(q, scale)


FP8_MAX = 448.0  # float8_e4m3fn finfo.max


def quantize_fp8(x: Array, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-channel FP8 (e4m3) quantisation (absmax / 448).

    Same :class:`QuantizedTensor` container as int8 — every consumer
    (weight-only matmul, paged int8/fp8 pages)
    dequantises via ``payload.astype(compute_dtype) * scales``, which is
    dtype-generic, so fp8 payloads flow through the same code.  FP8 keeps
    ~2 decimal digits of mantissa vs int8's uniform grid: better for
    long-tailed activations/KV, same 2x HBM saving.
    """
    absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=axis, keepdims=True)
    scale = jnp.where(absmax == 0, 1.0, absmax / FP8_MAX).astype(jnp.float32)
    q = (x.astype(jnp.float32) / scale).astype(jnp.float8_e4m3fn)
    return QuantizedTensor(q, scale)


def quantize_int8_stochastic(x: Array, seed: int | Array = 0) -> QuantizedTensor:
    """Per-row int8 quantisation with stochastic rounding.

    Unbiased rounding matters when quantised tensors feed gradients (e.g.
    int8 KV-cache during training).  2D input (rows, cols); rows scaled.
    ``round(x + u - 1/2)`` with ``u ~ U[0, 1)`` from ``jax.random`` is
    ``floor(x + u)``, whose expectation is ``x``.
    """
    absmax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    scale = jnp.where(absmax == 0, 1.0, absmax / 127.0).astype(jnp.float32)
    scaled = x / scale
    noise = jax.random.uniform(jax.random.PRNGKey(seed), x.shape) - 0.5
    q = jnp.clip(jnp.round(scaled + noise), -127, 127).astype(jnp.int8)
    return QuantizedTensor(q, scale)


def int8_weight_only_matmul(x: Array, w: QuantizedTensor) -> Array:
    """x (M, K) @ dequant(w) (K, N) with per-output-channel scales (1, N),
    accumulated in f32 and returned in ``x.dtype``.

    The payload is converted to ``x.dtype`` inside the product and the
    scales applied to its (M, N) result; XLA fuses the convert into the
    GEMM, so no dequantised copy of ``w`` is written.  int8 and fp8
    payloads alike.
    """
    m, k = x.shape
    k2, n = w.values.shape
    assert k == k2
    assert w.scales.shape == (1, n), "weight scales must be per output channel"
    acc = jnp.dot(x, w.values.astype(x.dtype),
                  preferred_element_type=jnp.float32)
    return (acc * w.scales).astype(x.dtype)


def quantize_model_weights(model, dtype=jnp.int8, min_params: int = 0):
    """Replace every Linear in a Module tree with a weight-only quantised
    QuantizedLinear (serving-time transform; int8 halves / fp8 halves weight
    HBM vs bf16, 4x vs f32).  ``min_params`` skips small layers."""
    from ..module import map_module_tree
    from ..nn.basic import Linear, quantize_linear

    def maybe_quantize(m):
        if isinstance(m, Linear) and m.weights.size >= min_params:
            return quantize_linear(m, dtype)
        return m

    return map_module_tree(model, maybe_quantize)
