"""Masked attention softmax as a plain XLA op.

The reference fused this into lightseq-derived CUDA kernels
(``src/softmax_kernel.cu``: fw ``ker_attn_softmax:124-224``, bw
``ker_attn_softmax_bw:308-341``) with launch tiers per ``to_len`` and a cap
at 1024.  XLA fuses the mask add, the row max/sum and the normalisation on
its own, so no kernel remains; the op keeps the reference's surface
(additive mask broadcast like its (B,1,F,T)/(1,1,F,T) masks, plus a
``causal`` flag that builds the triangular mask from iota instead of a
(B,H,T,T) tensor, modules_transfomer.py:63-71) with its in-place /
saved-tensor defect gone, and lifts the cap.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ._utils import DEFAULT_MASK_VALUE

Array = jax.Array


def attn_softmax(inp: Array, mask: Optional[Array] = None,
                 causal: bool = False) -> Array:
    """Masked softmax over the last dim of ``(B, H, F, T)`` scores, computed
    in f32 and returned in ``inp.dtype``.

    ``mask`` is an *additive* mask broadcastable as (B|1, H|1, F|1, T);
    ``causal=True`` additionally applies the triangular future mask.
    Matches reference ``Attn_Softmax`` (tensor_functions.py:435-451).
    """
    out = attn_softmax_reference(inp.astype(jnp.float32), mask, causal)
    return out.astype(inp.dtype)


def attn_softmax_reference(inp: Array, mask: Optional[Array] = None, causal: bool = False) -> Array:
    """Pure-jnp oracle for tests (the reference's op-graph baseline,
    kernel_tests/test_softmax_fw.py:60-72)."""
    x = inp
    if mask is not None:
        x = x + mask
    if causal:
        f, t = x.shape[-2:]
        rows = jnp.arange(f)[:, None]
        cols = jnp.arange(t)[None, :]
        x = jnp.where(cols <= rows, x, DEFAULT_MASK_VALUE)
    return jax.nn.softmax(x, axis=-1)
