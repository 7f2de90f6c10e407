"""Rotary position embeddings (RoPE, Su et al. 2021, arXiv:2104.09864).

No reference equivalent (the reference uses learned absolute position
embeddings sized by n_vocab, modules_transfomer.py:408); RoPE is the modern
default for decode-heavy serving because position information rides in the
q/k vectors themselves: the KV cache stores post-rotation keys, so decode
steps need no position-embedding lookup and extrapolate beyond training
lengths far better.

Shape notes: the rotation is a pure elementwise op on (B, H, S, D)
activations — XLA fuses it into the surrounding projection matmuls, so it
needs no kernel; the flash-attention kernel is position-agnostic
(rotation happens before Q/K enter it).  Pairing uses the GPT-NeoX
"rotate-half" convention (first D/2 dims paired with last D/2), which keeps
the lane layout contiguous instead of interleaving even/odd lanes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def rope_angles(positions: Array, head_dim: int,
                theta: float = 10000.0) -> tuple[Array, Array]:
    """(cos, sin) tables for ``positions`` (any shape), each
    ``positions.shape + (head_dim // 2,)`` in f32."""
    half = head_dim // 2
    freqs = theta ** (-jnp.arange(half, dtype=jnp.float32) / half)
    # atleast_1d: a scalar position (single decode step) must keep its own
    # sequence axis, not broadcast away against the frequency axis
    pos = jnp.atleast_1d(jnp.asarray(positions, jnp.float32))
    ang = pos[..., None] * freqs
    return jnp.cos(ang), jnp.sin(ang)


def apply_rope(x: Array, positions: Array, theta: float = 10000.0) -> Array:
    """Rotate ``x`` (..., S, D) by per-position angles.

    ``positions`` broadcasts against x's (..., S) prefix: pass (S,) for a
    full sequence, a scalar for one decode step, or (B, 1) per-row positions
    (paged decode at per-sequence lengths).  D must be even.
    """
    d = x.shape[-1]
    assert d % 2 == 0, f"RoPE head_dim must be even, got {d}"
    cos, sin = rope_angles(positions, d, theta)
    # broadcast (..., S, D/2) against x (..., H, S, D/2): insert axes so the
    # position prefix lines up from the right (S axis is x.ndim - 2)
    while cos.ndim < x.ndim:
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    x1, x2 = jnp.split(x.astype(jnp.float32), 2, axis=-1)
    out = jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.astype(x.dtype)
