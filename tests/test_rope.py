"""Rotary position embeddings: math properties + consistency across every
decode path (full forward, dense KV-cache decode, paged prefill+decode via
the serving engine)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import flashattn_tpu as ft
from flashattn_tpu.ops.rope import apply_rope
from flashattn_tpu.serving import ContinuousBatchingEngine


def test_rope_is_rotation():
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 4, 8, 32))
    y = apply_rope(x, jnp.arange(8))
    np.testing.assert_allclose(  # norms preserved per (pair of) lanes
        jnp.linalg.norm(x, axis=-1), jnp.linalg.norm(y, axis=-1),
        rtol=1e-5)
    # position 0 is the identity
    np.testing.assert_allclose(y[:, :, 0], x[:, :, 0], atol=1e-6)


def test_rope_scores_depend_on_relative_position_only():
    key = jax.random.PRNGKey(1)
    q = jax.random.normal(key, (1, 1, 1, 64))
    k = jax.random.normal(jax.random.PRNGKey(2), (1, 1, 1, 64))

    def score(pq, pk):
        qr = apply_rope(q, jnp.asarray([pq]))
        kr = apply_rope(k, jnp.asarray([pk]))
        return float(jnp.sum(qr * kr))

    assert score(5, 3) == pytest.approx(score(9, 7), rel=1e-5)
    assert score(5, 3) != pytest.approx(score(5, 4), rel=1e-3)


@pytest.fixture(scope="module")
def rope_model():
    return ft.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                        pos_encoding="rope", attn_impl="flash",
                        key=jax.random.PRNGKey(0)).eval()


def test_rope_model_has_no_position_table(rope_model):
    assert not hasattr(rope_model, "position_embeddings")
    names = [n for n, _ in rope_model.named_parameters()]
    assert not any("position_embeddings" in n for n in names)


def test_rope_model_is_position_sensitive_and_causal(rope_model):
    toks = jnp.asarray([[5, 9, 3, 7, 2, 8]], jnp.int32)
    base = rope_model(toks)
    # causality
    out = rope_model(toks.at[0, 4].set(11))
    np.testing.assert_allclose(base[:, :4], out[:, :4], atol=1e-6)
    # position sensitivity: the same token elsewhere scores differently
    # (a bag-of-words model would be invariant)
    swapped = jnp.asarray([[9, 5, 3, 7, 2, 8]], jnp.int32)
    assert not np.allclose(base[0, 2], rope_model(swapped)[0, 2], atol=1e-4)


def test_rope_cached_decode_matches_forward(rope_model):
    toks = jax.random.randint(jax.random.PRNGKey(3), (2, 10), 0, 64)
    want = rope_model(toks)
    caches = rope_model.init_cache(2, 10)
    got = []
    for i in range(10):
        logits, caches = rope_model.forward_decode(toks[:, i:i + 1], caches, i)
        got.append(logits[:, 0])
    np.testing.assert_allclose(np.stack(got, 1), want, atol=1e-4, rtol=1e-4)


def test_rope_paged_engine_matches_dense(rope_model):
    eng = ContinuousBatchingEngine(rope_model, max_batch=2, page_size=8,
                                   pages_per_seq=4, collect_logits=True)
    reqs = [eng.submit([3, 14, 15, 9, 2, 6], 6), eng.submit([27, 1, 8], 9)]
    eng.run()
    for r in reqs:
        full = r.prompt + r.generated
        want = np.asarray(rope_model(jnp.asarray([full[:len(r.logits)]],
                                                 jnp.int32))[0])
        np.testing.assert_allclose(np.stack(r.logits), want,
                                   atol=2e-4, rtol=2e-4)
