"""Paged attention decode kernel (Triton, interpreted here) vs the dense
oracle, and the route choice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu.ops.paged_attention import paged_attention, paged_attention_reference
from flashattn_tpu.ops.quant import quantize_int8


def _setup(b=3, hq=4, hkv=2, d=32, page=16, n_pages=12, pages_per_seq=4, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    q = jax.random.normal(ks[0], (b, hq, d))
    k_pages = jax.random.normal(ks[1], (hkv, n_pages, page, d))
    v_pages = jax.random.normal(ks[2], (hkv, n_pages, page, d))
    # non-contiguous page tables, disjoint-ish per sequence
    page_indices = jax.random.permutation(
        ks[3], jnp.arange(n_pages))[: b * pages_per_seq].reshape(b, pages_per_seq)
    lengths = jnp.asarray([page * pages_per_seq, page * 2 + 5, 1], jnp.int32)[:b]
    return q, k_pages, v_pages, lengths, page_indices


def test_paged_attention_matches_oracle():
    q, kp, vp, lengths, pidx = _setup()
    out = paged_attention(q, kp, vp, lengths, pidx_arg(pidx))
    ref = paged_attention_reference(q, kp, vp, lengths, pidx_arg(pidx))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


def pidx_arg(p):
    return p.astype(jnp.int32)


def test_paged_attention_gqa_grouping():
    # 8 query heads share 2 kv heads
    q, kp, vp, lengths, pidx = _setup(hq=8, hkv=2)
    out = paged_attention(q, kp, vp, lengths, pidx)
    ref = paged_attention_reference(q, kp, vp, lengths, pidx)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


def test_paged_attention_short_lengths():
    # length=1: only the first token of the first page attends
    q, kp, vp, _, pidx = _setup()
    lengths = jnp.asarray([1, 1, 1], jnp.int32)
    out = paged_attention(q, kp, vp, lengths, pidx)
    ref = paged_attention_reference(q, kp, vp, lengths, pidx)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


def test_paged_attention_int8_pages():
    q, kp, vp, lengths, pidx = _setup(seed=3)
    hkv, n_pages, page, d = kp.shape
    kq = quantize_int8(kp.reshape(-1, d)).values.reshape(kp.shape)
    ksc = quantize_int8(kp.reshape(-1, d)).scales.reshape(hkv, n_pages, page, 1)
    vq = quantize_int8(vp.reshape(-1, d)).values.reshape(vp.shape)
    vsc = quantize_int8(vp.reshape(-1, d)).scales.reshape(hkv, n_pages, page, 1)
    out = paged_attention(q, kq, vq, lengths, pidx, k_scales=ksc, v_scales=vsc)
    ref = paged_attention_reference(q, kq, vq, lengths, pidx, ksc, vsc)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-3)


def test_paged_attention_jit():
    q, kp, vp, lengths, pidx = _setup(seed=5)
    out = jax.jit(paged_attention)(q, kp, vp, lengths, pidx)
    ref = paged_attention_reference(q, kp, vp, lengths, pidx)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


class TestChunkedPaged:
    """Multi-token (chunk) decode: speculative verification / prefill-extend."""

    def _setup(self, d=128, hq=4, hkv=2, page=8, pps=8, b=3, seed=0):
        import jax

        ks = jax.random.split(jax.random.PRNGKey(seed), 3)
        n_pages = b * pps
        kp = jax.random.normal(ks[0], (hkv, n_pages, page, d))
        vp = jax.random.normal(ks[1], (hkv, n_pages, page, d))
        table = jnp.arange(n_pages, dtype=jnp.int32).reshape(b, pps)
        return kp, vp, table, ks[2]

    @pytest.mark.parametrize("page", [8, 16])
    @pytest.mark.parametrize("window", [None, 7])
    def test_chunk_vs_oracle(self, page, window):
        import jax

        kp, vp, table, key = self._setup(page=page, pps=64 // page)
        chunk = 4
        q = jax.random.normal(key, (3, chunk, 4, 128))
        lengths = jnp.asarray([45, chunk, 33], jnp.int32)  # incl. the chunk
        got = paged_attention(q, kp, vp, lengths, table, window=window,
                              impl="triton")
        want = paged_attention_reference(q, kp, vp, lengths, table,
                                         window=window)
        assert got.shape == (3, chunk, 4, 128)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)

    @pytest.mark.parametrize("page", [8, 16])
    def test_last_chunk_row_equals_single_token(self, page):
        import jax

        kp, vp, table, key = self._setup(page=page, pps=64 // page)
        chunk = 3
        q = jax.random.normal(key, (3, chunk, 4, 128))
        lengths = jnp.asarray([45, 17, 33], jnp.int32)
        got = paged_attention(q, kp, vp, lengths, table, impl="triton")
        single = paged_attention(q[:, -1], kp, vp, lengths, table,
                                 impl="triton")
        np.testing.assert_allclose(got[:, -1], single, atol=2e-5, rtol=1e-4)

    def test_chunk_int8_pages(self):
        import jax

        kp, vp, table, key = self._setup(d=64)
        ks = jnp.max(jnp.abs(kp), -1, keepdims=True) / 127.0
        kp8 = jnp.round(kp / ks).astype(jnp.int8)
        q = jax.random.normal(key, (3, 4, 4, 64))
        lengths = jnp.asarray([45, 8, 33], jnp.int32)
        got = paged_attention(q, kp8, kp8, lengths, table,
                              k_scales=ks, v_scales=ks)
        want = paged_attention_reference(q, kp8, kp8, lengths, table,
                                         k_scales=ks, v_scales=ks)
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)

    @pytest.mark.parametrize("window", [None, 200])
    def test_chunk_int8_pages_pipelined(self, window):
        """d=128 + page=128 int8 pools (the serving shape): one page per
        loop step, scales applied after the dots."""
        import jax

        kp, vp, table, key = self._setup(d=128, page=128, pps=4)
        ks = jnp.max(jnp.abs(kp), -1, keepdims=True) / 127.0
        vs = jnp.max(jnp.abs(vp), -1, keepdims=True) / 127.0
        kp8 = jnp.round(kp / ks).astype(jnp.int8)
        vp8 = jnp.round(vp / vs).astype(jnp.int8)
        q = jax.random.normal(key, (3, 4, 4, 128))
        lengths = jnp.asarray([450, 8, 331], jnp.int32)
        got = paged_attention(q, kp8, vp8, lengths, table,
                              k_scales=ks, v_scales=vs, impl="triton",
                              window=window)
        want = paged_attention_reference(q, kp8, vp8, lengths, table,
                                         k_scales=ks, v_scales=vs,
                                         window=window)
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("window", [None, 40])
def test_chunk_fp8_pages(window):
    """fp8-e4m3 pages with per-token scales, a chunk spanning several row
    blocks of the kernel."""
    from flashattn_tpu.models.transformer import _quantize_kv

    ks = jax.random.split(jax.random.PRNGKey(8), 3)
    kp = jax.random.normal(ks[0], (2, 12, 16, 32))
    vp = jax.random.normal(ks[1], (2, 12, 16, 32))
    kq, ksc = _quantize_kv(kp, jnp.float8_e4m3fn)
    vq, vsc = _quantize_kv(vp, jnp.float8_e4m3fn)
    table = jnp.arange(12, dtype=jnp.int32).reshape(2, 6)
    q = jax.random.normal(ks[2], (2, 40, 4, 32))
    lengths = jnp.asarray([90, 41], jnp.int32)
    got = paged_attention(q, kq, vq, lengths, table, k_scales=ksc,
                          v_scales=vsc, window=window, impl="triton")
    want = paged_attention_reference(q, kq, vq, lengths, table, ksc, vsc,
                                     window=window)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_route_choice():
    from flashattn_tpu.ops.paged_attention import choose_paged_impl

    assert choose_paged_impl(128, 128, platform="gpu") == "triton"
    assert choose_paged_impl(64, 16, platform="gpu") == "triton"
    # Triton needs power-of-two tiles: such shapes take the XLA gather
    assert choose_paged_impl(8, 128, platform="gpu") == "reference"
    assert choose_paged_impl(96, 128, platform="gpu") == "reference"
    assert choose_paged_impl(128, 24, platform="gpu") == "reference"
    # the interpreter takes every shape
    assert choose_paged_impl(8, 24, platform="cpu") == "triton"
    assert choose_paged_impl(8, 24, "reference", platform="cpu") == "reference"
    with pytest.raises(ValueError, match="impl must be one of"):
        choose_paged_impl(128, 128, "pallas")


def test_model_extend_matches_sequential_decode():
    """forward_extend_paged over k tokens == k sequential decode steps."""
    import jax

    import flashattn_tpu as ft

    model = ft.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                         attn_impl="flash",
                         key=jax.random.PRNGKey(0)).eval()
    b, page, pps = 2, 8, 8
    pools_a = model.init_page_pools(b * pps + 1, page)
    pools_b = model.init_page_pools(b * pps + 1, page)
    table = jnp.arange(b * pps, dtype=jnp.int32).reshape(b, pps)
    prompts = jnp.asarray([[5, 9, 3, 7, 2, 8], [11, 4, 6, 1, 1, 1]],
                          jnp.int32)
    plens = jnp.asarray([6, 3], jnp.int32)
    _, pools_a = model.forward_prefill_paged(prompts, pools_a, table, plens)
    _, pools_b = model.forward_prefill_paged(prompts, pools_b, table, plens)

    toks = jnp.asarray([[7, 12, 9, 4], [2, 30, 8, 15]], jnp.int32)
    got, pools_a = model.forward_extend_paged(toks, pools_a, table, plens)

    want = []
    lens = plens
    for j in range(4):
        lg, pools_b = model.forward_decode_paged(toks[:, j:j + 1], pools_b,
                                                 table, lens)
        want.append(lg[:, 0])
        lens = lens + 1
    np.testing.assert_allclose(got, np.stack(want, 1), atol=1e-4, rtol=1e-4)
    # pools end identical (same scatters through different paths)
    for pa, pb in zip(pools_a, pools_b):
        np.testing.assert_allclose(pa["k"], pb["k"], atol=1e-6)
