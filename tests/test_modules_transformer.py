"""Transformer module tests (mirrors reference tests/test_modules_transformer.py).

The reference checks its modules against torch with copied weights; here the
"reference" attention path (pure jnp op-graph) is the oracle and the fused /
flash paths must agree with it on identical weights -- same role, JAX-native
oracle (SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu import DecoderLM, FeedForward, MultiHeadAttention, TransformerLayer, F
from flashattn_tpu.optim import Adam


def test_mha_projection_shapes():
    mha = MultiHeadAttention(32, 4, causal=True, key=jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 10, 32))
    q, k, v = mha.project_to_query_key_value(x)
    assert q.shape == k.shape == v.shape == (2, 4, 10, 8)
    out = mha(x)
    assert out.shape == (2, 10, 32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["flash", "fused_softmax", "triton"])
def test_mha_impls_agree(causal, impl):
    base = MultiHeadAttention(64, 4, causal=causal, p_dropout=0.0,
                              attn_impl="reference", key=jax.random.PRNGKey(2))
    other = base.replace(attn_impl=impl)
    x = jax.random.normal(jax.random.PRNGKey(3), (2, 32, 64))
    np.testing.assert_allclose(base(x), other(x), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("impl,flash,paged", [
    ("flash", "auto", "auto"),
    ("cudnn", "cudnn", "auto"),
    ("triton", "triton", "triton"),
    ("fused_softmax", "auto", "auto"),
    ("reference", "reference", "reference"),
])
def test_attn_impl_names_the_routes(impl, flash, paged):
    """One field picks the attention route: the flash calls' ``impl`` and
    the paged-decode calls' ``impl``."""
    mha = MultiHeadAttention(32, 4, causal=True, attn_impl=impl,
                             key=jax.random.PRNGKey(0))
    assert (mha._flash_route, mha._paged_route) == (flash, paged)


def test_mha_manual_oracle():
    """MHA against a hand-rolled computation with the same weights."""
    mha = MultiHeadAttention(16, 2, causal=False, p_dropout=0.0,
                             attn_impl="reference", key=jax.random.PRNGKey(4))
    x = jax.random.normal(jax.random.PRNGKey(5), (1, 6, 16))
    q = x @ mha.q_projection.weights + mha.q_projection.bias
    k = x @ mha.k_projection.weights + mha.k_projection.bias
    v = x @ mha.v_projection.weights + mha.v_projection.bias

    def split(t):
        return np.asarray(t).reshape(1, 6, 2, 8).transpose(0, 2, 1, 3)

    qh, kh, vh = split(q), split(k), split(v)
    s = qh @ kh.transpose(0, 1, 3, 2) / np.sqrt(8)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    attn = (p @ vh).transpose(0, 2, 1, 3).reshape(1, 6, 16)
    expected = attn @ np.asarray(mha.out_projection.weights) + np.asarray(mha.out_projection.bias)
    np.testing.assert_allclose(mha(x), expected, atol=1e-5)


def test_feedforward_shapes_and_gelu():
    ff = FeedForward(32, 64, p_dropout=0.0, key=jax.random.PRNGKey(6))
    x = jax.random.normal(jax.random.PRNGKey(7), (2, 5, 32))
    out = ff(x)
    assert out.shape == (2, 5, 32)
    manual = F.GELU(x @ ff.linear_in.weights + ff.linear_in.bias)
    manual = manual @ ff.linear_out.weights + ff.linear_out.bias
    np.testing.assert_allclose(out, manual, atol=1e-5)


@pytest.mark.parametrize("impl", ["flash", "fused_softmax"])
def test_transformer_layer_impls_agree(impl):
    ref = TransformerLayer(64, 4, p_dropout=0.0, attn_impl="reference",
                           key=jax.random.PRNGKey(8))
    other = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(
            TransformerLayer(64, 4, p_dropout=0.0, attn_impl=impl,
                             key=jax.random.PRNGKey(8))),
        jax.tree_util.tree_leaves(ref),
    )
    x = jax.random.normal(jax.random.PRNGKey(9), (2, 32, 64))
    np.testing.assert_allclose(ref(x), other(x), atol=1e-4, rtol=1e-4)


def test_decoder_lm_forward_shapes():
    model = DecoderLM(128, 64, 4, 40, p_dropout=0.1, n_layer=2,
                      attn_impl="reference", key=jax.random.PRNGKey(10))
    idx = jax.random.randint(jax.random.PRNGKey(11), (3, 20), 0, 128)
    logits = model(idx)
    assert logits.shape == (3, 20, 128)
    # dropout active only with a key in train mode
    l1 = model(idx, key=jax.random.PRNGKey(1))
    assert not np.allclose(np.asarray(l1), np.asarray(logits))
    np.testing.assert_allclose(model.eval()(idx), logits)


def test_decoder_lm_is_causal():
    """Changing a future token must not change past logits."""
    model = DecoderLM(64, 32, 2, 16, p_dropout=0.0, n_layer=2,
                      attn_impl="flash", key=jax.random.PRNGKey(12))
    idx = jax.random.randint(jax.random.PRNGKey(13), (1, 16), 0, 64)
    idx2 = idx.at[0, -1].set((idx[0, -1] + 1) % 64)
    l1, l2 = model(idx), model(idx2)
    np.testing.assert_allclose(l1[0, :-1], l2[0, :-1], atol=1e-5)
    assert not np.allclose(np.asarray(l1[0, -1]), np.asarray(l2[0, -1]))


def test_decoder_lm_trains():
    model = DecoderLM(32, 32, 2, 16, p_dropout=0.0, n_layer=1,
                      attn_impl="flash", key=jax.random.PRNGKey(14))
    idx = jax.random.randint(jax.random.PRNGKey(15), (8, 16), 0, 32)

    def loss_fn(m):
        logits = m(idx[:, :-1])
        return jnp.mean(F.softmax_loss(
            logits.reshape(-1, 32), idx[:, 1:].reshape(-1)))

    opt = Adam(lr=1e-2)
    state = opt.init(model)
    l0 = float(loss_fn(model))

    @jax.jit
    def step(m, s):
        loss, grads = jax.value_and_grad(loss_fn)(m)
        m, s = opt.step(m, grads, s)
        return m, s, loss

    for _ in range(10):
        model, state, loss = step(model, state)
    assert float(loss) < l0 * 0.9


class TestGQAModel:
    """DecoderLM with grouped-query attention (n_kv_head < n_head)."""

    def _model(self, attn_impl="flash"):
        import flashattn_tpu as ft

        return ft.DecoderLM(64, 32, 4, 128, p_dropout=0.0, n_layer=2,
                            n_kv_head=2, attn_impl=attn_impl,
                            key=jax.random.PRNGKey(0)).eval()

    def test_forward_paths_agree(self):
        toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 64)
        outs = [np.asarray(self._model(impl)(toks))
                for impl in ("flash", "fused_softmax", "reference")]
        np.testing.assert_allclose(outs[0], outs[2], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(outs[1], outs[2], atol=1e-4, rtol=1e-4)

    def test_dense_decode_matches_forward(self):
        model = self._model("reference")
        toks = jax.random.randint(jax.random.PRNGKey(2), (2, 10), 0, 64)
        full = model(toks)
        caches = model.init_cache(2, 16)
        outs = []
        for i in range(10):
            logits, caches = model.forward_decode(toks[:, i:i + 1], caches, i)
            outs.append(np.asarray(logits[:, 0]))
        np.testing.assert_allclose(np.stack(outs, 1), np.asarray(full),
                                   atol=1e-4, rtol=1e-4)

    def test_gqa_serving_engine(self):
        from flashattn_tpu.serving import ContinuousBatchingEngine

        model = self._model("reference")
        rng = np.random.default_rng(3)
        t = list(rng.integers(1, 60, size=12))
        eng = ContinuousBatchingEngine(model, max_batch=2, page_size=8,
                                       pages_per_seq=4, collect_logits=True)
        r = eng.submit(t, 1)
        eng.run()
        want = np.asarray(model(jnp.asarray([t], jnp.int32))[0])
        np.testing.assert_allclose(np.stack(r.logits), want,
                                   atol=1e-4, rtol=1e-4)

    def test_gqa_params_smaller(self):
        import flashattn_tpu as ft

        mha = ft.DecoderLM(64, 32, 4, 128, n_layer=1, key=jax.random.PRNGKey(0))
        gqa = ft.DecoderLM(64, 32, 4, 128, n_layer=1, n_kv_head=1,
                           key=jax.random.PRNGKey(0))
        assert gqa.layers[0].attention.k_projection.weights.shape == (32, 8)
        assert mha.layers[0].attention.k_projection.weights.shape == (32, 32)
