"""Fused dropout ops (ops/dropout.py): semantics + wiring.

The ops are plain ``jax.numpy`` compositions that XLA fuses; they must
reproduce the op-graph composition bit-for-bit (same bernoulli mask from
the same key), which is what ``nn.functional`` computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import flashattn_tpu.nn.functional as F
from flashattn_tpu.ops.dropout import (
    fused_dropout,
    fused_dropout_act_bias,
    fused_dropout_res_bias,
)


def _manual_dropout(x, rate, key):
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    return jnp.where(keep, x, jnp.zeros_like(x)) / (1.0 - rate)


def test_fused_dropout_matches_opgraph():
    key = jax.random.PRNGKey(3)
    x = jax.random.normal(jax.random.PRNGKey(0), (64, 256))
    np.testing.assert_array_equal(fused_dropout(x, 0.3, key),
                                  _manual_dropout(x, 0.3, key))
    np.testing.assert_array_equal(fused_dropout(x, 0.0, key), x)
    np.testing.assert_array_equal(fused_dropout(x, 0.3, None), x)


def test_res_bias_matches_opgraph():
    key = jax.random.PRNGKey(5)
    x = jax.random.normal(jax.random.PRNGKey(0), (32, 128))
    b = jax.random.normal(jax.random.PRNGKey(1), (128,))
    r = jax.random.normal(jax.random.PRNGKey(2), (32, 128))
    got = fused_dropout_res_bias(x, b, r, 0.25, key)
    want = r + _manual_dropout(x + b, 0.25, key)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # rate=0 / no key: plain residual + bias add
    np.testing.assert_allclose(fused_dropout_res_bias(x, b, r, 0.0, key),
                               r + x + b, atol=1e-6)
    np.testing.assert_allclose(fused_dropout_res_bias(x, b, r, 0.5, None),
                               r + x + b, atol=1e-6)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_act_bias_matches_opgraph(act):
    key = jax.random.PRNGKey(7)
    x = jax.random.normal(jax.random.PRNGKey(0), (32, 128))
    b = jax.random.normal(jax.random.PRNGKey(1), (128,))
    y = F.GELU(x + b) if act == "gelu" else jnp.maximum(x + b, 0.0)
    got = fused_dropout_act_bias(x, b, 0.25, key, act)
    want = _manual_dropout(y, 0.25, key)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(fused_dropout_act_bias(x, b, 0.0, key, act),
                               y, atol=1e-6)


def test_act_bias_rejects_unknown_act():
    x = jnp.zeros((8, 128))
    b = jnp.zeros((128,))
    with pytest.raises(ValueError):
        fused_dropout_act_bias(x, b, 0.1, jax.random.PRNGKey(0), "swish")


def test_functional_wiring_unchanged_on_cpu():
    """F.dropout / F.dropout_res_bias / F.dropout_act_bias produce the
    op-graph values through the fused ops."""
    key = jax.random.PRNGKey(11)
    x = jax.random.normal(jax.random.PRNGKey(0), (16, 384))
    b = jax.random.normal(jax.random.PRNGKey(1), (384,))
    r = jax.random.normal(jax.random.PRNGKey(2), (16, 384))
    np.testing.assert_array_equal(F.dropout(x, 0.3, key, scale=True),
                                  _manual_dropout(x, 0.3, key))
    keep = jax.random.bernoulli(key, 0.7, x.shape)
    np.testing.assert_array_equal(F.dropout(x, 0.3, key, scale=False),
                                  jnp.where(keep, x, 0.0))
    np.testing.assert_allclose(F.dropout_res_bias(x, b, r, 0.25, key),
                               r + _manual_dropout(x + b, 0.25, key),
                               atol=1e-6)
    np.testing.assert_allclose(F.dropout_act_bias(x, b, 0.25, key),
                               _manual_dropout(F.GELU(x + b), 0.25, key),
                               atol=1e-6)


def test_grads_flow_through_fallbacks():
    key = jax.random.PRNGKey(13)
    x = jax.random.normal(jax.random.PRNGKey(0), (16, 128))
    b = jax.random.normal(jax.random.PRNGKey(1), (128,))
    r = jax.random.normal(jax.random.PRNGKey(2), (16, 128))

    g = jax.grad(lambda a, bb, rr: jnp.sum(
        fused_dropout_res_bias(a, bb, rr, 0.25, key)), argnums=(0, 1, 2))(
            x, b, r)
    keep = jax.random.bernoulli(key, 0.75, x.shape)
    np.testing.assert_allclose(g[0], keep / 0.75, atol=1e-6)
    np.testing.assert_allclose(g[1], jnp.sum(keep / 0.75, axis=0), atol=1e-4)
    np.testing.assert_allclose(g[2], jnp.ones_like(r), atol=1e-6)


def test_keep_rate_and_mask_reuse_under_jit():
    """The keep fraction tracks 1 - rate, and one key gives one mask inside
    and outside jit (the backward relies on the same mask)."""
    key = jax.random.PRNGKey(17)
    x = jnp.ones((256, 512))
    out = np.asarray(jax.jit(lambda a: fused_dropout(a, 0.2, key))(x))
    assert abs((out > 0).mean() - 0.8) < 0.01
    np.testing.assert_array_equal(out, fused_dropout(x, 0.2, key))
    np.testing.assert_allclose(out[out > 0], 1.0 / 0.8, rtol=1e-6)
