"""Module tree semantics (mirrors reference tests/test_module.py) plus
pytree/jit/grad behaviour unique to the JAX build."""

import jax
import jax.numpy as jnp
import numpy as np

from flashattn_tpu import Adam, Linear, Module


class MLP(Module):
    def __init__(self, key):
        k1, k2 = jax.random.split(key)
        self.l1 = Linear(4, 8, key=k1)
        self.l2 = Linear(8, 2, key=k2)
        self.scale = 2.0  # static

    def forward(self, x):
        return self.l2(jnp.tanh(self.l1(x))) * self.scale


def test_named_parameters():
    m = MLP(jax.random.PRNGKey(0))
    names = [n for n, _ in m.named_parameters()]
    assert names == ["l1.bias", "l1.weights", "l2.bias", "l2.weights"]
    assert m.num_parameters() == 4 * 8 + 8 + 8 * 2 + 2


def test_modules_walk():
    m = MLP(jax.random.PRNGKey(0))
    assert len(m.modules()) == 2


def test_train_eval_functional():
    m = MLP(jax.random.PRNGKey(0))
    assert m.training
    e = m.eval()
    assert not e.training and m.training  # original untouched
    assert not e.l1.training
    t = e.train()
    assert t.training and t.l2.training


def test_pytree_roundtrip():
    m = MLP(jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(m)
    m2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(m2, MLP)
    assert m2.scale == 2.0
    x = jnp.ones((3, 4))
    np.testing.assert_allclose(m(x), m2(x))


def test_jit_and_grad_through_module():
    m = MLP(jax.random.PRNGKey(0))
    x = jnp.ones((3, 4))

    @jax.jit
    def loss_fn(model):
        return jnp.sum(model(x) ** 2)

    grads = jax.grad(loss_fn)(m)
    assert isinstance(grads, MLP)
    assert grads.l1.weights.shape == m.l1.weights.shape
    # grads are nonzero
    assert float(jnp.abs(grads.l2.weights).sum()) > 0


def test_optimizer_reduces_loss():
    m = MLP(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (16, 4))
    y = jax.random.normal(jax.random.PRNGKey(2), (16, 2))

    def loss_fn(model):
        return jnp.mean((model(x) - y) ** 2)

    opt = Adam(lr=1e-2)
    state = opt.init(m)
    l0 = float(loss_fn(m))
    for _ in range(20):
        grads = jax.grad(loss_fn)(m)
        m, state = opt.step(m, grads, state)
    assert float(loss_fn(m)) < l0 * 0.9


def test_replace():
    m = MLP(jax.random.PRNGKey(0))
    m2 = m.replace(scale=3.0)
    assert m2.scale == 3.0 and m.scale == 2.0
