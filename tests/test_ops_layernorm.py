"""LayerNorm (the XLA-fused op, f32 statistics) vs the jnp oracle (mirrors
reference kernel_tests/test_layernorm_fw.py / _bw.py and tests around
LayerNorm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu import layernorm, layernorm_reference
from flashattn_tpu.autodiff import grad_check

SHAPES = [(8, 128), (37, 256), (256, 1024), (5, 64), (128, 4096), (1, 8192)]


@pytest.mark.parametrize("shape", SHAPES)
def test_layernorm_forward(shape):
    n, h = shape
    key = jax.random.PRNGKey(hash(shape) % 2**31)
    k1, k2, k3 = jax.random.split(key, 3)
    x = jax.random.normal(k1, shape) * 3.0 + 1.0
    gamma = jax.random.normal(k2, (h,)) * 0.2 + 1.0
    beta = jax.random.normal(k3, (h,)) * 0.1
    np.testing.assert_allclose(
        layernorm(x, gamma, beta), layernorm_reference(x, gamma, beta),
        atol=1e-5, rtol=1e-5,
    )


def test_layernorm_3d_input():
    x = jax.random.normal(jax.random.PRNGKey(0), (4, 10, 64))
    gamma, beta = jnp.ones((64,)), jnp.zeros((64,))
    np.testing.assert_allclose(
        layernorm(x, gamma, beta), layernorm_reference(x, gamma, beta), atol=1e-5
    )


@pytest.mark.parametrize("shape", [(16, 128), (37, 64)])
def test_layernorm_backward_vs_oracle(shape):
    n, h = shape
    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    x = jax.random.normal(k1, shape) * 2.0
    gamma = jax.random.normal(k2, (h,)) * 0.2 + 1.0
    beta = jax.random.normal(k3, (h,)) * 0.1
    dy = jax.random.normal(k4, shape)

    def fused(x, g, b):
        return jnp.sum(layernorm(x, g, b) * dy)

    def oracle(x, g, b):
        return jnp.sum(layernorm_reference(x, g, b) * dy)

    gf = jax.grad(fused, argnums=(0, 1, 2))(x, gamma, beta)
    go = jax.grad(oracle, argnums=(0, 1, 2))(x, gamma, beta)
    for a, b_, name in zip(gf, go, ["dx", "dgamma", "dbeta"]):
        np.testing.assert_allclose(a, b_, atol=1e-4, rtol=1e-4, err_msg=name)


def test_layernorm_grad_check_numerical():
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 16))
    gamma = jnp.ones((16,)) * 1.3
    beta = jnp.zeros((16,)) + 0.2
    grad_check(lambda x, g, b: layernorm(x, g, b), x, gamma, beta,
               n_samples=8, tol=2e-2, epsilon=1e-3)


def test_layernorm_jit():
    x = jax.random.normal(jax.random.PRNGKey(3), (64, 256))
    gamma, beta = jnp.ones((256,)), jnp.zeros((256,))
    np.testing.assert_allclose(
        jax.jit(layernorm)(x, gamma, beta), layernorm_reference(x, gamma, beta),
        atol=1e-5,
    )
