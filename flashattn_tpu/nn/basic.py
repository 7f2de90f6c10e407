"""Basic NN modules: Embedding, Dropout, Linear, LayerNorm1d.

JAX equivalents of reference ``minitorch/modules_basic.py:29-210``.
Initialisation distributions match the reference (Embedding ~ N(0,1),
Linear ~ U(+-1/sqrt(in_size))), but use ``jax.random`` with explicit keys.

Deliberate fixes of reference defects (SURVEY.md §2 "known defects"):
* ``LayerNorm1d`` here *does* apply gamma/beta, as trainable parameters
  (the reference forgets them, modules_basic.py:194-198, and its
  ``FusedLayerNorm`` builds them as plain tensors, :206-207); set
  ``elementwise_affine=False`` for bug-for-bug comparison in tests.  It is
  the one LayerNorm: the reference's fused kernel is XLA's fusion here.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..module import Module
from . import functional as F

Array = jax.Array


class Embedding(Module):
    """Token embedding (reference modules_basic.py:29-71).

    The reference computes ``one_hot(x) @ weight`` -- a host-side np.eye
    followed by a full matmul.  Here an embedding is a gather
    (``weights[x]``); XLA lowers it to a dynamic-gather that never
    materialises the one-hot.  ``use_one_hot_matmul=True`` keeps the
    matmul formulation (it can be faster on tiny vocabs since it maps to the
    tensor cores, and is the semantics the reference tests check).
    """

    def __init__(self, num_embeddings: int, embedding_dim: int, *, key: jax.Array,
                 use_one_hot_matmul: bool = False, dtype=jnp.float32):
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.use_one_hot_matmul = use_one_hot_matmul
        self.weights = jax.random.normal(
            key, (num_embeddings, embedding_dim), dtype=dtype
        )

    def forward(self, x: Array) -> Array:
        """(batch, seq) int -> (batch, seq, embedding_dim)."""
        if self.use_one_hot_matmul:
            bs, seq = x.shape
            oh = F.one_hot(x, self.num_embeddings).reshape(bs * seq, self.num_embeddings)
            out = oh.astype(self.weights.dtype) @ self.weights
            return out.reshape(bs, seq, self.embedding_dim)
        return jnp.take(self.weights, x.astype(jnp.int32), axis=0)


class Dropout(Module):
    """Inverted dropout (reference modules_basic.py:74-104) with explicit key."""

    def __init__(self, p_dropout: float = 0.1):
        self.p_dropout = float(p_dropout)

    def forward(self, x: Array, key: Optional[jax.Array] = None) -> Array:
        if self.p_dropout == 0.0 or not self.training or key is None:
            return x
        return F.dropout(x, self.p_dropout, key=key, scale=True)


class Linear(Module):
    """y = x @ W + b with W:(in,out) (reference modules_basic.py:107-157).

    Note the reference stores W as (in_size, out_size) -- no transpose --
    which is also the layout the GEMM takes without a transpose.
    """

    def __init__(self, in_size: int, out_size: int, bias: bool = True, *,
                 key: jax.Array, dtype=jnp.float32):
        self.in_size = in_size
        self.out_size = out_size
        wkey, bkey = jax.random.split(key)
        bound = 1.0 / (in_size**0.5)
        self.weights = jax.random.uniform(
            wkey, (in_size, out_size), minval=-bound, maxval=bound, dtype=dtype
        )
        if bias:
            self.bias = jax.random.uniform(
                bkey, (out_size,), minval=-bound, maxval=bound, dtype=dtype
            )
        else:
            self.bias = None

    def forward(self, x: Array) -> Array:
        out = jnp.dot(x, self.weights, preferred_element_type=x.dtype)
        if self.bias is not None:
            out = out + self.bias
        return out


class LayerNorm1d(Module):
    """LayerNorm over the last dim (reference modules_basic.py:160-210,
    ``LayerNorm1d`` and ``FusedLayerNorm`` in one module).

    Statistics in f32 (:func:`flashattn_tpu.ops.layernorm.layernorm`);
    gamma/beta are trainable parameters.
    """

    def __init__(self, dim: int, eps: float = 1e-5, *, elementwise_affine: bool = True,
                 dtype=jnp.float32):
        self.dim = dim
        self.eps = float(eps)
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.gamma = jnp.ones((dim,), dtype=dtype)
            self.beta = jnp.zeros((dim,), dtype=dtype)

    def forward(self, x: Array) -> Array:
        from ..ops.layernorm import layernorm

        if self.elementwise_affine:
            return layernorm(x, self.gamma, self.beta, eps=self.eps)
        ones = jnp.ones((self.dim,), x.dtype)
        return layernorm(x, ones, jnp.zeros_like(ones), eps=self.eps)


class QuantizedLinear(Module):
    """Weight-only quantised Linear (int8 or fp8-e4m3 payload + per-output-
    channel f32 scales): y = x @ dequant(W) + b with the convert fused into
    the GEMM (ops/quant.py) -- W never exists at full precision in device
    memory.

    The reference only declares this surface (kernels.h:30,101-175).
    Built from a trained Linear via :func:`quantize_linear` /
    ``parallel-free`` model transform
    :func:`flashattn_tpu.ops.quant.quantize_model_weights`.
    """

    def __init__(self, values, scales, bias, in_size: int, out_size: int):
        self.in_size = in_size
        self.out_size = out_size
        self.values = values          # (in, out) int8 / fp8
        self.scales = scales          # (1, out) f32
        self.bias = bias

    def forward(self, x):
        from ..ops.quant import QuantizedTensor, int8_weight_only_matmul

        w = QuantizedTensor(self.values, self.scales)
        x2 = x.reshape(-1, x.shape[-1])
        out = int8_weight_only_matmul(x2, w)
        out = out.reshape(x.shape[:-1] + (self.out_size,))
        if self.bias is not None:
            out = out + self.bias
        return out


def quantize_linear(lin: Linear, dtype=jnp.int8) -> QuantizedLinear:
    """Quantise a trained Linear's weights per output channel."""
    from ..ops.quant import quantize_fp8, quantize_int8

    q = (quantize_int8 if dtype == jnp.int8 else quantize_fp8)(
        lin.weights, axis=0)
    return QuantizedLinear(q.values, q.scales, lin.bias,
                           lin.in_size, lin.out_size)
