"""Masked attention softmax (the XLA-fused op) vs the jnp oracle (mirrors
reference kernel_tests/test_softmax_fw.py / _bw.py, without the
to_len<=1024 cap)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu import attn_softmax, attn_softmax_reference

SHAPES = [(1, 2, 8, 16), (2, 4, 64, 96), (2, 2, 128, 128), (1, 1, 17, 33),
          (1, 2, 64, 2048)]  # last one exceeds the reference's 1024 cap


def _inputs(shape, seed=0):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    x = jax.random.normal(k1, shape) * 3.0
    # additive padding mask over the to_len dim, broadcast over heads/queries
    b, h, f, t = shape
    keep = jax.random.bernoulli(k2, 0.85, (b, 1, 1, t))
    mask = jnp.where(keep, 0.0, -1e9).astype(jnp.float32)
    return x, mask


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_attn_softmax_forward(shape, causal):
    x, mask = _inputs(shape)
    np.testing.assert_allclose(
        attn_softmax(x, mask, causal), attn_softmax_reference(x, mask, causal),
        atol=1e-6, rtol=1e-5,
    )
    np.testing.assert_allclose(
        attn_softmax(x, None, causal), attn_softmax_reference(x, None, causal),
        atol=1e-6, rtol=1e-5,
    )


def test_attn_softmax_mask_broadcast_full():
    x, _ = _inputs((2, 4, 32, 32), 3)
    # (1,1,F,T) causal-style additive mask like the reference builds
    f = t = 32
    tri = jnp.where(jnp.arange(t)[None, :] <= jnp.arange(f)[:, None], 0.0, -1e9)
    mask = tri[None, None].astype(jnp.float32)
    np.testing.assert_allclose(
        attn_softmax(x, mask, False), attn_softmax_reference(x, None, True),
        atol=1e-5,
    )


@pytest.mark.parametrize("causal", [False, True])
def test_attn_softmax_backward(causal):
    x, mask = _inputs((2, 2, 32, 48), 7)
    dy = jax.random.normal(jax.random.PRNGKey(9), x.shape)

    g = jax.grad(lambda x: jnp.sum(attn_softmax(x, mask, causal) * dy))(x)
    gr = jax.grad(lambda x: jnp.sum(attn_softmax_reference(x, mask, causal) * dy))(x)
    np.testing.assert_allclose(g, gr, atol=1e-5, rtol=1e-4)


def test_attn_softmax_rows_sum_to_one():
    x, mask = _inputs((1, 2, 16, 64), 11)
    out = np.asarray(attn_softmax(x, mask, True))
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    # no attention to masked-out or future positions
    masked = np.broadcast_to(np.asarray(mask) < -1.0, out.shape)
    assert out[masked].max(initial=0.0) < 1e-6
    future = np.triu(np.ones((16, 64), bool), k=1)[None, None]
    assert out[np.broadcast_to(future, out.shape)].max(initial=0.0) < 1e-6
