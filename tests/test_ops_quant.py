"""Quantization tier tests: int8/fp8 tensors, the weight-only matmul, and
quantised KV pages through the paged decode and serving routes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu.ops.quant import (
    QuantizedTensor,
    int8_weight_only_matmul,
    quantize_int8,
    quantize_int8_stochastic,
)


def test_quantize_roundtrip_error_bound():
    x = jax.random.normal(jax.random.PRNGKey(0), (64, 128)) * 3.0
    q = quantize_int8(x, axis=-1)
    assert q.values.dtype == jnp.int8
    err = np.abs(np.asarray(q.dequantize() - x))
    # max error is half a quantisation step = absmax/127/2 per row
    bound = np.asarray(jnp.max(jnp.abs(x), axis=-1, keepdims=True)) / 127.0
    assert (err <= bound * 0.5 + 1e-6).all()


def test_quantize_zero_row():
    x = jnp.zeros((4, 16))
    q = quantize_int8(x)
    np.testing.assert_array_equal(np.asarray(q.dequantize()), 0.0)


def test_stochastic_quantize_unbiased():
    x = jnp.full((8, 256), 0.37)
    qs = [quantize_int8_stochastic(x, seed=i).dequantize() for i in range(8)]
    mean = np.mean([np.asarray(q).mean() for q in qs])
    # stochastic rounding is unbiased in expectation
    np.testing.assert_allclose(mean, 0.37, rtol=0.02)


def test_int8_weight_only_matmul_matches_dequant():
    key = jax.random.PRNGKey(1)
    x = jax.random.normal(key, (256, 512))
    w = jax.random.normal(jax.random.PRNGKey(2), (512, 256))
    wq = quantize_int8(w, axis=0)  # per-output-channel
    out = int8_weight_only_matmul(x, wq)
    ref = x @ wq.dequantize()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-3)


def test_int8_weight_only_matmul_ragged_fallback():
    x = jax.random.normal(jax.random.PRNGKey(3), (33, 48))
    w = jax.random.normal(jax.random.PRNGKey(4), (48, 17))
    wq = quantize_int8(w, axis=0)
    out = int8_weight_only_matmul(x, wq)
    np.testing.assert_allclose(out, x @ wq.dequantize(), atol=1e-4)


def test_int8_weight_only_matmul_bf16_activations():
    """bf16 activations: f32 accumulation, bf16 result, scales after the dot."""
    x = jax.random.normal(jax.random.PRNGKey(21), (8, 256)).astype(jnp.bfloat16)
    w = jax.random.normal(jax.random.PRNGKey(22), (256, 64))
    wq = quantize_int8(w, axis=0)
    out = int8_weight_only_matmul(x, wq)
    assert out.dtype == jnp.bfloat16
    want = x.astype(jnp.float32) @ wq.dequantize()
    np.testing.assert_allclose(np.asarray(out, np.float32), want, atol=5e-2,
                               rtol=2e-2)


def test_int8_weight_only_matmul_converts_inside_the_product():
    """The payload enters the dot as a convert of the int8 array (which XLA
    fuses into the GEMM), never as a dequantised (values * scales) copy."""
    x = jnp.ones((4, 64), jnp.bfloat16)
    wq = quantize_int8(jnp.ones((64, 32)), axis=0)
    text = str(jax.make_jaxpr(int8_weight_only_matmul)(x, wq))
    assert "dot_general" in text
    dot_line = next(l for l in text.splitlines() if "dot_general" in l)
    # the scales multiply the (4, 32) product, not a (64, 32) weight copy
    assert "f32[64,32]" not in text and "bf16[64,32]" in text, dot_line


def test_int8_weight_only_matmul_grad_wrt_activations():
    x = jax.random.normal(jax.random.PRNGKey(23), (4, 32))
    wq = quantize_int8(jax.random.normal(jax.random.PRNGKey(24), (32, 16)),
                       axis=0)
    g = jax.grad(lambda a: jnp.sum(int8_weight_only_matmul(a, wq)))(x)
    want = jnp.broadcast_to(jnp.sum(wq.dequantize(), axis=1), x.shape)
    np.testing.assert_allclose(g, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [jnp.int8, jnp.float8_e4m3fn])
def test_kv_page_quantisation_bound(dtype):
    """Per-token KV quantisation of the paged pools (models/transformer.py):
    int8 within half a step of absmax/127, fp8 within e4m3's ~6%."""
    from flashattn_tpu.models.transformer import _quantize_kv

    t = jax.random.normal(jax.random.PRNGKey(25), (2, 5, 8, 32)) * 3.0
    payload, scale = _quantize_kv(t, dtype)
    assert payload.dtype == dtype and scale.shape == t.shape[:-1] + (1,)
    back = payload.astype(jnp.float32) * scale
    absmax = jnp.max(jnp.abs(t), -1, keepdims=True)
    bound = absmax / 254.0 + 1e-6 if dtype == jnp.int8 else absmax * 0.07
    assert bool((jnp.abs(back - t) <= bound).all())


@pytest.mark.parametrize("dtype", [jnp.int8, jnp.float8_e4m3fn])
def test_quantised_pages_close_to_full_precision(dtype):
    """Decode over quantised pages stays within the quantisation bound of
    decode over the same pages in f32 (the Triton route, interpreted)."""
    from flashattn_tpu.models.transformer import _quantize_kv
    from flashattn_tpu.ops.paged_attention import paged_attention

    ks = jax.random.split(jax.random.PRNGKey(26), 3)
    kp = jax.random.normal(ks[0], (2, 8, 16, 32))
    vp = jax.random.normal(ks[1], (2, 8, 16, 32))
    table = jnp.arange(8, dtype=jnp.int32).reshape(2, 4)
    lengths = jnp.asarray([64, 21], jnp.int32)
    q = jax.random.normal(ks[2], (2, 4, 32))
    full = paged_attention(q, kp, vp, lengths, table, impl="triton")
    kq, ksc = _quantize_kv(kp, dtype)
    vq, vsc = _quantize_kv(vp, dtype)
    quant = paged_attention(q, kq, vq, lengths, table, k_scales=ksc,
                            v_scales=vsc, impl="triton")
    tol = 0.03 if dtype == jnp.int8 else 0.15
    assert float(jnp.max(jnp.abs(quant - full))) < tol


def test_fp8_kv_pool_engine_matches_dense():
    """An fp8 KV pool serves through the engine within fp8's bound of the
    dense forward (prefill logits)."""
    import flashattn_tpu as ft
    from flashattn_tpu.serving import ContinuousBatchingEngine

    model = ft.DecoderLM(64, 32, 4, 128, p_dropout=0.0, n_layer=2,
                         attn_impl="flash",
                         key=jax.random.PRNGKey(0)).eval()
    t = list(np.random.default_rng(3).integers(1, 60, size=12))
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=8,
                                   pages_per_seq=4, dtype=jnp.float8_e4m3fn,
                                   collect_logits=True)
    r = eng.submit(t, 3)
    eng.run()
    want = np.asarray(model(jnp.asarray([t + r.generated[:-1]], jnp.int32))[0])
    got = np.stack(r.logits)
    assert got.shape == want.shape
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 0.1, rel


def test_quantize_fp8_roundtrip():
    from flashattn_tpu.ops.quant import quantize_fp8

    x = jax.random.normal(jax.random.PRNGKey(7), (64, 128)) * 5.0
    xq = quantize_fp8(x, axis=-1)
    assert xq.values.dtype == jnp.float8_e4m3fn
    # e4m3 keeps ~2 significant digits; relative error bounded by ~6%
    err = jnp.max(jnp.abs(xq.dequantize() - x)) / jnp.max(jnp.abs(x))
    assert float(err) < 0.07


def test_fp8_weight_only_matmul():
    from flashattn_tpu.ops.quant import quantize_fp8

    x = jax.random.normal(jax.random.PRNGKey(9), (32, 64))
    w = jax.random.normal(jax.random.PRNGKey(10), (64, 128))
    wq = quantize_fp8(w, axis=0)
    out = int8_weight_only_matmul(x, wq)
    np.testing.assert_allclose(out, x @ wq.dequantize(), atol=1e-4, rtol=1e-4)


def test_quantize_int8_stochastic_unaligned_rows():
    """654 rows has no 8-aligned divisor <= 256: ragged-block regression."""
    from flashattn_tpu.ops.quant import quantize_int8_stochastic

    x = jax.random.normal(jax.random.PRNGKey(11), (654, 64))
    xq = quantize_int8_stochastic(x, seed=3)
    err = jnp.max(jnp.abs(xq.dequantize() - x))
    assert float(err) < 0.1


class TestWeightOnlyModel:
    """quantize_model_weights: serving-time Linear -> QuantizedLinear."""

    def _model(self):
        import flashattn_tpu as ft

        return ft.DecoderLM(64, 32, 4, 128, p_dropout=0.0, n_layer=2,
                            attn_impl="flash",
                            key=jax.random.PRNGKey(0)).eval()

    @pytest.mark.parametrize("dtype", [jnp.int8, jnp.float8_e4m3fn])
    def test_forward_close_to_fp(self, dtype):
        from flashattn_tpu.ops.quant import quantize_model_weights

        model = self._model()
        qmodel = quantize_model_weights(model, dtype)
        toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, 64)
        full = np.asarray(model(toks))
        quant = np.asarray(qmodel(toks))
        rel = np.max(np.abs(quant - full)) / np.max(np.abs(full))
        assert rel < 0.05, rel
        # argmax agreement stays high
        agree = np.mean(np.argmax(quant, -1) == np.argmax(full, -1))
        assert agree > 0.85

    def test_weights_are_quantized(self):
        from flashattn_tpu.nn.basic import QuantizedLinear
        from flashattn_tpu.ops.quant import quantize_model_weights

        qmodel = quantize_model_weights(self._model(), jnp.int8)
        lin = qmodel.layers[0].attention.q_projection
        assert isinstance(lin, QuantizedLinear)
        assert lin.values.dtype == jnp.int8
        assert qmodel.lm_head.values.dtype == jnp.int8

    def test_quantized_model_serves(self):
        from flashattn_tpu.ops.quant import quantize_model_weights
        from flashattn_tpu.serving import ContinuousBatchingEngine

        model = self._model()
        qmodel = quantize_model_weights(model, jnp.int8)
        rng = np.random.default_rng(2)
        t = list(rng.integers(1, 60, size=10))
        eng = ContinuousBatchingEngine(qmodel, max_batch=2, page_size=8,
                                       pages_per_seq=4, collect_logits=True)
        r = eng.submit(t, 3)
        eng.run()
        want = np.asarray(model(jnp.asarray([t], jnp.int32))[0])
        got = np.stack(r.logits)[:len(t)]
        rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert rel < 0.05, rel
