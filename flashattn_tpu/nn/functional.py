"""Functional nn ops.

JAX equivalents of the reference's ``minitorch/nn.py`` (softmax:104,
logsoftmax:126, GELU:205, one_hot:212, logsumexp:229, softmax_loss:251,
dropout:167, argmax:64, max:100, tile:12, avgpool2d:39, maxpool2d:149).

All functions are pure jnp and fuse under ``jax.jit``; the reference's
``max_reduce`` backend selection (nn.py:56-61) disappears -- XLA owns the
reduction.  Dropout takes an explicit PRNG key instead of host-side numpy
randomness (reference modules_basic.py:98) so it is reproducible and
jit-compatible.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def max(input: Array, dim: int) -> Array:  # noqa: A001
    """Max reduction keeping the reduced dim (size 1), like reference nn.max."""
    return jnp.max(input, axis=dim, keepdims=True)


def argmax(input: Array, dim: int) -> Array:
    """Argmax as a 1-hot tensor (reference nn.py:64-78 semantics)."""
    out = jnp.max(input, axis=dim, keepdims=True)
    return (input == out).astype(input.dtype)


def softmax(input: Array, dim: int) -> Array:
    r""":math:`z_i = e^{x_i} / \sum_i e^{x_i}` along ``dim`` (stable)."""
    return jax.nn.softmax(input, axis=dim)


def logsoftmax(input: Array, dim: int) -> Array:
    r""":math:`z_i = x_i - \log\sum_i e^{x_i}` along ``dim`` (stable)."""
    return jax.nn.log_softmax(input, axis=dim)


def logsumexp(input: Array, dim: int) -> Array:
    """Stable logsumexp, keepdims=True (parity with reference nn.py:229-248)."""
    return jax.scipy.special.logsumexp(input, axis=dim, keepdims=True)


def GELU(input: Array) -> Array:
    """GELU with tanh approximation (reference nn.py:205-209)."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * input * (1.0 + jnp.tanh(c * (input + 0.044715 * input**3)))


def one_hot(input: Array, num_classes: int) -> Array:
    """Indices ``(*,)`` -> one-hot ``(*, num_classes)`` (reference nn.py:212-222).

    Device-resident ``jax.nn.one_hot`` instead of host ``np.eye`` gathers.
    """
    return jax.nn.one_hot(input.astype(jnp.int32), num_classes, dtype=jnp.float32)


def softmax_loss(logits: Array, target: Array) -> Array:
    """Per-example cross entropy, ``reduction=None`` (reference nn.py:251-271).

    loss_i = logsumexp(logits_i) - logits_i[target_i]
    """
    lse = jax.scipy.special.logsumexp(logits, axis=1)
    picked = jnp.take_along_axis(
        logits, target.astype(jnp.int32)[:, None], axis=1
    )[:, 0]
    return lse - picked


def dropout(
    input: Array,
    rate: float,
    key: Optional[jax.Array] = None,
    ignore: bool = False,
    scale: bool = True,
) -> Array:
    """Dropout with explicit PRNG key.

    ``scale=True`` gives inverted dropout (reference modules_basic.Dropout);
    ``scale=False`` matches reference nn.dropout:167-185 which does *not*
    rescale.  With ``ignore=True`` or ``key=None`` this is the identity.

    The scaled path is ``ops.dropout.fused_dropout`` (the same composition,
    which XLA fuses).
    """
    if ignore or rate <= 0.0 or key is None:
        return input
    if scale:
        from ..ops.dropout import fused_dropout

        return fused_dropout(input, rate, key)
    keep = jax.random.bernoulli(key, 1.0 - rate, input.shape)
    return jnp.where(keep, input, jnp.zeros_like(input))


def dropout_res_bias(
    input: Array,
    bias: Array,
    residual: Array,
    rate: float,
    key: Optional[jax.Array] = None,
) -> Array:
    """Fused residual + dropout(input + bias) — the reference's
    ``launch_ls_dropout_res_bias`` surface (src/includes/kernels.h:118-122,
    declared-only there).

    ``ops.dropout.fused_dropout_res_bias``: the op-graph composition, which
    XLA fuses.  Inverted-dropout scaling matches LightSeq's 1/(1-ratio).
    """
    from ..ops.dropout import fused_dropout_res_bias

    return fused_dropout_res_bias(input, bias, residual, rate, key)


def dropout_act_bias(
    input: Array,
    bias: Array,
    rate: float,
    key: Optional[jax.Array] = None,
    act: str = "gelu",
) -> Array:
    """Fused dropout(act(input + bias)) — the reference's
    ``launch_ls_dropout_act_bias`` surface (src/includes/kernels.h:123-126).

    ``act``: "gelu" (tanh approximation, matching :func:`GELU`) or "relu".
    ``ops.dropout.fused_dropout_act_bias``: the op-graph composition, which
    XLA fuses (the reference declares a separate ``_bwd`` launcher,
    kernels.h:128-137; here JAX differentiates the composition).
    """
    from ..ops.dropout import fused_dropout_act_bias

    return fused_dropout_act_bias(input, bias, rate, key, act)


# ---------------------------------------------------------------------------
# Pooling (reference nn.py:12-54,149-164)
# ---------------------------------------------------------------------------


def tile(input: Array, kernel: Tuple[int, int]) -> Tuple[Array, int, int]:
    """Reshape (B,C,H,W) for 2D pooling -> (B,C,H/kh,W/kw,kh*kw)."""
    batch, channel, height, width = input.shape
    kh, kw = kernel
    assert height % kh == 0
    assert width % kw == 0
    new_height, new_width = height // kh, width // kw
    x = input.reshape(batch, channel, new_height, kh, new_width, kw)
    x = x.transpose(0, 1, 2, 4, 3, 5)
    return x.reshape(batch, channel, new_height, new_width, kh * kw), new_height, new_width


def avgpool2d(input: Array, kernel: Tuple[int, int]) -> Array:
    """Tiled average pooling 2D."""
    batch, channel, _, _ = input.shape
    x, nh, nw = tile(input, kernel)
    return jnp.mean(x, axis=4).reshape(batch, channel, nh, nw)


def maxpool2d(input: Array, kernel: Tuple[int, int]) -> Array:
    """Tiled max pooling 2D."""
    batch, channel, _, _ = input.shape
    x, nh, nw = tile(input, kernel)
    return jnp.max(x, axis=4).reshape(batch, channel, nh, nw)


def layer_norm(input: Array, eps: float = 1e-5, axis: int = -1) -> Array:
    """Plain (unfused, no-affine) layer norm over ``axis``."""
    mean = jnp.mean(input, axis=axis, keepdims=True)
    var = jnp.var(input, axis=axis, keepdims=True)
    return (input - mean) * jax.lax.rsqrt(var + eps)
