"""Basic module semantics (mirrors reference tests/test_modules_basic.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu import (
    Dropout,
    Embedding,
    LayerNorm1d,
    Linear,
    layernorm_reference,
)


def test_embedding_shapes_and_gather_matmul_equiv():
    key = jax.random.PRNGKey(0)
    emb = Embedding(50, 16, key=key)
    emb_oh = emb.replace(use_one_hot_matmul=True)
    x = jax.random.randint(jax.random.PRNGKey(1), (4, 7), 0, 50)
    out = emb(x)
    assert out.shape == (4, 7, 16)
    np.testing.assert_allclose(out, emb_oh(x), atol=1e-5)
    # row lookup semantics
    np.testing.assert_allclose(out[0, 0], emb.weights[x[0, 0]])


def test_embedding_init_distribution():
    emb = Embedding(1000, 64, key=jax.random.PRNGKey(2))
    w = np.asarray(emb.weights)
    assert abs(w.mean()) < 0.05 and abs(w.std() - 1.0) < 0.05  # N(0,1)


def test_linear_matches_manual():
    lin = Linear(8, 3, bias=True, key=jax.random.PRNGKey(3))
    x = jax.random.normal(jax.random.PRNGKey(4), (5, 8))
    np.testing.assert_allclose(
        lin(x), np.asarray(x) @ np.asarray(lin.weights) + np.asarray(lin.bias),
        rtol=1e-5, atol=1e-6,
    )
    # init bounds: U(+-1/sqrt(in))
    bound = 1 / 8**0.5
    assert np.abs(np.asarray(lin.weights)).max() <= bound
    assert np.abs(np.asarray(lin.bias)).max() <= bound


def test_linear_no_bias_and_batched_input():
    lin = Linear(8, 3, bias=False, key=jax.random.PRNGKey(5))
    assert lin.bias is None
    x = jax.random.normal(jax.random.PRNGKey(6), (2, 7, 8))
    assert lin(x).shape == (2, 7, 3)


def test_dropout_train_eval():
    d = Dropout(0.5)
    x = jnp.ones((50, 50))
    key = jax.random.PRNGKey(7)
    out = d(x, key=key)
    assert 0.3 < float((np.asarray(out) > 0).mean()) < 0.7
    # eval mode and no-key are identity
    np.testing.assert_array_equal(d.eval()(x, key=key), x)
    np.testing.assert_array_equal(d(x), x)
    np.testing.assert_array_equal(Dropout(0.0)(x, key=key), x)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_modules_match_oracle(dtype):
    ln = LayerNorm1d(32, 1e-5)
    x = jax.random.normal(jax.random.PRNGKey(8), (10, 32)) * 2 + 1
    if dtype == jnp.bfloat16:
        # f32 statistics over bf16 input: agrees with the oracle on the
        # same bf16 values up to the output's bf16 rounding
        xb = x.astype(dtype)
        out = ln(xb)
        assert out.dtype == dtype
        np.testing.assert_allclose(
            np.asarray(out, np.float32),
            layernorm_reference(xb.astype(jnp.float32), jnp.ones((32,)),
                                jnp.zeros((32,)), 1e-5),
            atol=2e-2)
        return
    gamma = jnp.ones((32,))
    beta = jnp.zeros((32,))
    np.testing.assert_allclose(
        ln(x), layernorm_reference(x, gamma, beta, 1e-5), atol=1e-5
    )


def test_fused_layernorm_params_are_trainable():
    ln = LayerNorm1d(16)
    names = [n for n, _ in ln.named_parameters()]
    assert "gamma" in names and "beta" in names
    # gradient flows to gamma/beta (the reference defect made them untrainable)
    x = jax.random.normal(jax.random.PRNGKey(9), (4, 16))
    g = jax.grad(lambda m: jnp.sum(m(x) ** 2))(ln)
    assert float(jnp.abs(g.gamma).sum()) > 0
    assert float(jnp.abs(g.beta).sum()) > 0
