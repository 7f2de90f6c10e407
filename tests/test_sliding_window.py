"""Sliding-window (local causal) flash attention: Triton kernels vs oracle,
grads, model paths.  No reference equivalent (the reference caps context by memory;
windowed attention makes compute AND KV traffic O(seq * window))."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import flashattn_tpu as ft
from flashattn_tpu.ops.flash_attention import (
    flash_attention as _flash,
    flash_attention_reference,
)

flash = functools.partial(_flash, impl="triton")


def _qkv(b, h, n, d, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jax.random.normal(ks[0], (b, h, n, d)),
            jax.random.normal(ks[1], (b, h, n, d)),
            jax.random.normal(ks[2], (b, h, n, d)))


def _oracle(q, k, v, window):
    """Independent dense construction (not the shared masking helper)."""
    n = q.shape[2]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                   preferred_element_type=jnp.float32) / np.sqrt(q.shape[-1])
    i = jnp.arange(n)[:, None]
    j = jnp.arange(n)[None, :]
    s = jnp.where((j <= i) & (j > i - window), s, -1e30)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), v)


# windows chosen to hit: window < block, == block, spanning blocks, > seq
@pytest.mark.parametrize("n,window", [
    (256, 16), (256, 64), (256, 300), (512, 128), (384, 100),
])
def test_forward_vs_oracle(n, window):
    q, k, v = _qkv(1, 2, n, 32)
    got = flash(q, k, v, True, window=window)
    want = _oracle(q, k, v, window)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    # and the shared jnp reference path agrees with the independent oracle
    ref = flash_attention_reference(q, k, v, True, window=window)
    np.testing.assert_allclose(ref, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("n,window", [(256, 48), (512, 128)])
def test_backward_vs_oracle(n, window):
    q, k, v = _qkv(1, 2, n, 32, seed=1)
    dy = jax.random.normal(jax.random.PRNGKey(9), q.shape)

    g = jax.grad(lambda q, k, v: jnp.sum(
        flash(q, k, v, True, window=window) * dy), argnums=(0, 1, 2))(q, k, v)
    gr = jax.grad(lambda q, k, v: jnp.sum(
        _oracle(q, k, v, window) * dy), argnums=(0, 1, 2))(q, k, v)
    for a, b, nm in zip(g, gr, "qkv"):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-4, rtol=1e-3, err_msg=f"d{nm}")


def test_window_equals_full_when_large():
    q, k, v = _qkv(1, 2, 128, 32, seed=2)
    got = flash(q, k, v, True, window=4096)
    want = flash(q, k, v, True)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_window_requires_causal():
    from flashattn_tpu.ops.flash_attention import flash_attention_varlen

    q, k, v = _qkv(1, 1, 64, 16)
    lens = jnp.asarray([64], jnp.int32)
    with pytest.raises(ValueError, match="causal"):
        _flash(q, k, v, False, window=16)
    with pytest.raises(ValueError, match=">= 1"):
        _flash(q, k, v, True, window=0)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_varlen(q, k, v, lens, False, window=16)
    with pytest.raises(ValueError, match=">= 1"):
        flash_attention_varlen(q, k, v, lens, True, window=0)


def test_model_window_and_cached_decode():
    """DecoderLM(window=W): full forward matches the oracle mask, and the
    dense-cache decode path applies the same window."""
    model = ft.DecoderLM(64, 32, 4, 64, p_dropout=0.0, n_layer=2,
                         window=8, attn_impl="reference",
                         key=jax.random.PRNGKey(0)).eval()
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0, 64)
    want = model(toks)
    caches = model.init_cache(2, 24)
    got = []
    for i in range(24):
        logits, caches = model.forward_decode(toks[:, i:i + 1], caches, i)
        got.append(logits[:, 0])
    np.testing.assert_allclose(np.stack(got, 1), want, atol=1e-4, rtol=1e-4)

    # tokens outside the receptive field (n_layer stacked windows) do not
    # influence the output: with 2 layers x window 8, position >= 16 cannot
    # see token 0
    far = toks.at[:, 0].set((toks[:, 0] + 7) % 64)
    np.testing.assert_allclose(model(far)[:, 16:], want[:, 16:], atol=1e-5)


def test_model_window_impls_agree():
    mk = lambda impl: ft.DecoderLM(64, 32, 4, 64, p_dropout=0.0, n_layer=1,
                                   window=8, attn_impl=impl,
                                   key=jax.random.PRNGKey(3)).eval()
    toks = jax.random.randint(jax.random.PRNGKey(4), (2, 48), 0, 64)
    ref = mk("reference")(toks)
    for impl in ("flash", "fused_softmax"):
        np.testing.assert_allclose(mk(impl)(toks), ref,
                                   atol=2e-5, rtol=1e-4, err_msg=impl)


@pytest.mark.parametrize("page", [8, 16])
def test_paged_decode_window(page):
    from flashattn_tpu.ops.paged_attention import (
        paged_attention, paged_attention_reference)

    key = jax.random.PRNGKey(0)
    b, h, d, pps = 3, 2, 128, 48 // page
    n_pages = b * pps
    q = jax.random.normal(key, (b, h, d))
    kp = jax.random.normal(jax.random.PRNGKey(1), (h, n_pages, page, d))
    vp = jax.random.normal(jax.random.PRNGKey(2), (h, n_pages, page, d))
    table = jnp.arange(n_pages, dtype=jnp.int32).reshape(b, pps)
    lengths = jnp.asarray([45, 8, 33], jnp.int32)
    for window in (16, 5, 100):
        got = paged_attention(q, kp, vp, lengths, table, window=window,
                              impl="triton")
        want = paged_attention_reference(q, kp, vp, lengths, table,
                                         window=window)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4,
                                   err_msg=f"window={window}")


def test_varlen_window_kernel():
    from flashattn_tpu.ops.flash_attention import flash_attention_varlen

    q, k, v = _qkv(2, 2, 256, 32, seed=5)
    lens = jnp.asarray([256, 100], jnp.int32)
    got = flash_attention_varlen(q, k, v, lens, True, impl="triton",
                                 window=48)
    # oracle: dense per-row window+causal+prefix mask
    n = 256
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                   preferred_element_type=jnp.float32) / np.sqrt(32)
    i = jnp.arange(n)[:, None]
    j = jnp.arange(n)[None, :]
    keep = (j <= i) & (j > i - 48)
    keep = keep[None] & (jnp.arange(n)[None, None, :] < lens[:, None, None])
    s = jnp.where(keep[:, None], s, -1e30)
    want = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), v)
    # rows whose window lies entirely past their valid prefix are fully
    # masked; the kernel's empty-row convention outputs zeros
    want = jnp.where(keep.any(-1)[:, None, :, None], want, 0.0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_windowed_engine_matches_dense_forward():
    """Serving engine with a windowed model: prefill+paged-decode logits
    must equal the dense windowed forward."""
    from flashattn_tpu.serving import ContinuousBatchingEngine

    model = ft.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                         window=8, attn_impl="flash",
                         key=jax.random.PRNGKey(0)).eval()
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=4,
                                   pages_per_seq=8, collect_logits=True)
    reqs = [eng.submit([3, 14, 15, 9, 2, 6, 5, 35, 8, 9, 7, 9], 8),
            eng.submit([27, 1, 8], 12)]
    eng.run()
    for r in reqs:
        full = r.prompt + r.generated
        want = np.asarray(model(jnp.asarray([full[:len(r.logits)]],
                                            jnp.int32))[0])
        np.testing.assert_allclose(np.stack(r.logits), want,
                                   atol=2e-4, rtol=2e-4)


def test_rolling_buffer_frees_pages_behind_window():
    """Windowed model => the engine returns pages behind the window to the
    pool: a request whose full history would exhaust the pool completes
    untruncated, and its logits still match the dense windowed forward."""
    from flashattn_tpu.serving import ContinuousBatchingEngine

    model = ft.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                         window=8, attn_impl="flash",
                         key=jax.random.PRNGKey(0)).eval()
    # full history = 12 prompt + 30 generated = 42 tokens = 11 pages of 4;
    # pool has only 8 — impossible without releasing behind the window
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=4,
                                   pages_per_seq=16, total_pages=8,
                                   collect_logits=True)
    r = eng.submit([3, 14, 15, 9, 2, 6, 5, 35, 8, 9, 7, 9], 30)
    eng.run()
    assert r.done and not r.truncated
    assert len(r.generated) == 30
    assert eng.pool.n_free == eng.pool.total
    full = r.prompt + r.generated
    want = np.asarray(model(jnp.asarray([full[:len(r.logits)]],
                                        jnp.int32))[0])
    np.testing.assert_allclose(np.stack(r.logits), want, atol=2e-4, rtol=2e-4)


def test_varlen_window_fully_masked_rows_multi_tile():
    """varlen + window at multi-tile blocks: rows past kv_len + window - 1
    have NO live keys — kernel and oracle must both emit exactly 0 there and
    agree (fwd and grads) on live rows.  Regression: the oracle previously
    zeroed only kv_lengths-masked positions, so such rows emitted a spurious
    uniform average over the prefix (and polluted dV)."""
    from flashattn_tpu.ops.flash_attention import (
        flash_attention_reference, flash_attention_varlen)

    key = jax.random.PRNGKey(0)
    q = jax.random.normal(key, (3, 1, 64, 16), jnp.float32)
    lens = jnp.asarray([64, 33, 16], jnp.int32)
    win = 24

    o_k = flash_attention_varlen(q, q, q, lens, True, impl="triton",
                                 window=win)
    o_r = flash_attention_reference(q, q, q, True, kv_lengths=lens,
                                    window=win)
    np.testing.assert_allclose(np.asarray(o_k), np.asarray(o_r),
                               atol=2e-5, rtol=1e-4)
    # fully-masked rows (r >= len + win - 1) are exactly zero in BOTH
    for b, ln in enumerate([64, 33, 16]):
        dead = np.arange(64) >= ln + win - 1
        if dead.any():
            assert np.abs(np.asarray(o_k)[b, :, dead]).max() == 0.0
            assert np.abs(np.asarray(o_r)[b, :, dead]).max() == 0.0

    def loss_k(q, k, v):
        return jnp.sum(flash_attention_varlen(
            q, k, v, lens, True, impl="triton", window=win) ** 2)

    def loss_r(q, k, v):
        return jnp.sum(flash_attention_reference(
            q, k, v, True, kv_lengths=lens, window=win) ** 2)

    g_k = jax.grad(loss_k, argnums=(0, 1, 2))(q, q, q)
    g_r = jax.grad(loss_r, argnums=(0, 1, 2))(q, q, q)
    for a, b, name in zip(g_k, g_r, "qkv"):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-3,
                                   err_msg=f"d{name} mismatch")


def test_window_engine_composes_with_prompt_lookup():
    """Sliding-window rolling page release + prompt-lookup waves: outputs
    identical to the plain windowed engine, pages all returned."""
    from flashattn_tpu.serving import ContinuousBatchingEngine

    model = ft.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                         window=8, attn_impl="flash",
                         key=jax.random.PRNGKey(5)).eval()
    prompt = [5, 9, 2, 5, 9, 2, 5, 9, 2]
    plain = ContinuousBatchingEngine(model, max_batch=1, page_size=4,
                                     pages_per_seq=16)
    want = plain.submit(list(prompt), 14)
    plain.run()
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=4,
                                   pages_per_seq=16, prompt_lookup=3)
    req = eng.submit(list(prompt), 14)
    eng.run()
    assert req.generated == want.generated
    assert eng.pool.n_free == eng.pool.total
