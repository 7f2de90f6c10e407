"""Flash attention routes vs the jnp oracle.

Mirrors the reference's test strategy (tests/test_flash_attention.py:24-186):
sweep (batch, seq, heads, head_dim) x {causal, non-causal}, forward and
backward against a full-softmax oracle, plus central-difference grad checks.
The oracle plays the role torch plays in the reference.  The Triton kernels
run through the Pallas interpreter here, so shapes are small; the card's
compiled runs are in tests/test_gpu_routes.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu import flash_attention as _flash_attention, flash_attention_reference
from flashattn_tpu.autodiff import grad_check
from flashattn_tpu.ops import flash_attention as fa

# pin the Triton kernels: this file tests them (auto takes the XLA op graph
# on the CPU)
flash_attention = functools.partial(_flash_attention, impl="triton")

# (batch, heads, seq, head_dim); 48/33 and d=24 exercise the padding of
# ragged sequences and head dims to the kernels' power-of-two tiles
SHAPES = [
    (1, 1, 16, 16),
    (2, 4, 64, 32),
    (1, 2, 128, 64),
    (2, 2, 256, 16),
    (1, 1, 48, 24),
    (1, 2, 33, 16),
]


def _qkv(shape, seed=0, kv_len=None):
    b, h, n, d = shape
    key = jax.random.PRNGKey(seed)
    kq, kk, kv = jax.random.split(key, 3)
    q = jax.random.normal(kq, (b, h, n, d))
    nk = kv_len or n
    k = jax.random.normal(kk, (b, h, nk, d))
    v = jax.random.normal(kv, (b, h, nk, d))
    return q, k, v


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_oracle(shape, causal):
    q, k, v = _qkv(shape, seed=sum(shape))
    out = flash_attention(q, k, v, causal)
    ref = flash_attention_reference(q, k, v, causal)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_cross_attention_lengths(causal):
    # kv longer than q (generation-style shapes); causal is top-left aligned
    # on every route (row i attends columns <= i)
    q, k, v = _qkv((1, 2, 32, 16), seed=5, kv_len=128)
    np.testing.assert_allclose(
        flash_attention(q, k, v, causal),
        flash_attention_reference(q, k, v, causal),
        atol=1e-5, rtol=1e-5,
    )


@pytest.mark.parametrize("shape", [(2, 2, 64, 32), (1, 2, 128, 16)])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_oracle(shape, causal):
    q, k, v = _qkv(shape, seed=11)
    dy = jax.random.normal(jax.random.PRNGKey(3), q.shape)

    def fused(q, k, v):
        return jnp.sum(flash_attention(q, k, v, causal) * dy)

    def oracle(q, k, v):
        return jnp.sum(flash_attention_reference(q, k, v, causal) * dy)

    g = jax.grad(fused, argnums=(0, 1, 2))(q, k, v)
    gr = jax.grad(oracle, argnums=(0, 1, 2))(q, k, v)
    for a, b, name in zip(g, gr, ["dq", "dk", "dv"]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=name)


def test_grad_check_numerical():
    q, k, v = _qkv((1, 1, 16, 8), seed=13)
    grad_check(lambda q, k, v: flash_attention(q, k, v, True), q, k, v,
               n_samples=6, tol=2e-2, epsilon=1e-3)


def test_sm_scale_and_jit():
    q, k, v = _qkv((1, 2, 64, 32), seed=17)
    out = jax.jit(lambda q, k, v: flash_attention(q, k, v, False, 0.5))(q, k, v)
    ref = flash_attention_reference(q, k, v, False, 0.5)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_block_sizes_do_not_change_result():
    """A causal row sees only earlier columns, so the first 200 rows of a
    256-long sequence equal a 200-long one: padding to the tile and the
    tile boundaries change nothing."""
    q, k, v = _qkv((1, 2, 256, 32), seed=19)
    base = flash_attention(q, k, v, True)
    for n in (200, 130, 64):
        out = flash_attention(q[:, :, :n], k[:, :, :n], v[:, :, :n], True)
        np.testing.assert_allclose(out, base[:, :, :n], atol=1e-5, rtol=1e-5)


def test_causal_first_row_attends_only_self():
    q, k, v = _qkv((1, 1, 32, 16), seed=23)
    out = flash_attention(q, k, v, True)
    np.testing.assert_allclose(out[0, 0, 0], v[0, 0, 0], atol=1e-5)


class TestVarlen:
    """flash_attention_varlen: per-row KV-prefix masking fused in-kernel."""

    def _args(self, b=3, h=2, n=128, d=32, seed=0):
        ks = jax.random.split(jax.random.PRNGKey(seed), 3)
        q = jax.random.normal(ks[0], (b, h, n, d))
        k = jax.random.normal(ks[1], (b, h, n, d))
        v = jax.random.normal(ks[2], (b, h, n, d))
        lengths = jnp.asarray([n, n // 2, 17], jnp.int32)
        return q, k, v, lengths

    @pytest.mark.parametrize("causal", [False, True])
    def test_forward(self, causal):
        from flashattn_tpu.ops.flash_attention import flash_attention_varlen

        q, k, v, lengths = self._args()
        got = flash_attention_varlen(q, k, v, lengths, causal, impl="triton")
        want = flash_attention_reference(q, k, v, causal, kv_lengths=lengths)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)

    def test_backward(self):
        from flashattn_tpu.ops.flash_attention import flash_attention_varlen

        q, k, v, lengths = self._args(seed=1)
        dy = jax.random.normal(jax.random.PRNGKey(9), q.shape)

        def loss_k(q, k, v):
            return jnp.sum(flash_attention_varlen(
                q, k, v, lengths, True, impl="triton") * dy)

        def loss_r(q, k, v):
            return jnp.sum(flash_attention_reference(
                q, k, v, True, kv_lengths=lengths) * dy)

        g = jax.grad(loss_k, argnums=(0, 1, 2))(q, k, v)
        gr = jax.grad(loss_r, argnums=(0, 1, 2))(q, k, v)
        for a, b_, nm in zip(g, gr, "qkv"):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b_),
                                       atol=1e-4, rtol=1e-3,
                                       err_msg=f"d{nm}")
        # grads w.r.t. masked-out K/V positions are zero
        dk = np.asarray(g[1])
        assert np.abs(dk[2, :, 17:]).max() == 0.0

    def test_zero_length_row(self):
        from flashattn_tpu.ops.flash_attention import flash_attention_varlen

        q, k, v, _ = self._args(seed=2)
        lengths = jnp.asarray([128, 1, 0], jnp.int32)
        out = flash_attention_varlen(q, k, v, lengths, False, impl="triton")
        assert bool(jnp.isfinite(out).all())
        # a zero-length row attends nothing -> zeros (empty-softmax guard)
        np.testing.assert_array_equal(np.asarray(out[2]), 0.0)

    def test_auto_dispatch_small_seq(self):
        from flashattn_tpu.ops.flash_attention import flash_attention_varlen

        q, k, v, lengths = self._args(n=64, seed=3)
        lengths = jnp.asarray([64, 30, 5], jnp.int32)
        got = flash_attention_varlen(q, k, v, lengths, True)  # auto -> jnp
        want = flash_attention_reference(q, k, v, True, kv_lengths=lengths)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    def test_lse_of_zero_length_row(self):
        q, k, v, _ = self._args(seed=4)
        lengths = jnp.asarray([128, 5, 0], jnp.int32)
        o, lse = fa._triton_fwd(q, k, v, lengths, True, 32 ** -0.5, None)
        want_o, want_lse = fa._reference_fwd_with_lse(q, k, v, True,
                                                      32 ** -0.5, lengths)
        np.testing.assert_allclose(o, want_o, atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(lse[:2], want_lse[:2], atol=1e-4)
        assert bool(jnp.isneginf(lse[2]).all())


class TestGQA:
    """Grouped-query attention: Hq > Hkv, kv heads shared per group (the
    kernels map heads by index -- no k/v repeat materialised)."""

    def _args(self, hq=8, hkv=2, n=128, d=32, seed=0):
        ks = jax.random.split(jax.random.PRNGKey(seed), 3)
        q = jax.random.normal(ks[0], (2, hq, n, d))
        k = jax.random.normal(ks[1], (2, hkv, n, d))
        v = jax.random.normal(ks[2], (2, hkv, n, d))
        return q, k, v

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 1)])
    def test_forward(self, causal, hq, hkv):
        q, k, v = self._args(hq, hkv)
        got = flash_attention(q, k, v, causal)
        want = flash_attention_reference(q, k, v, causal)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)

    @pytest.mark.parametrize("impl", ["auto", "triton"])
    def test_backward(self, impl):
        # "triton" runs the kernels, including the dK/dV group sum; "auto"
        # covers the op-graph vjp the CPU dispatches to.
        q, k, v = self._args(seed=1)
        dy = jax.random.normal(jax.random.PRNGKey(9), q.shape)

        g = jax.grad(lambda q, k, v: jnp.sum(
            _flash_attention(q, k, v, True, impl=impl) * dy),
            argnums=(0, 1, 2))(q, k, v)
        gr = jax.grad(lambda q, k, v: jnp.sum(
            flash_attention_reference(q, k, v, True) * dy),
            argnums=(0, 1, 2))(q, k, v)
        for a, b, nm in zip(g, gr, "qkv"):
            assert a.shape == b.shape, nm  # dk/dv in the ORIGINAL kv shape
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-4, rtol=1e-3,
                                       err_msg=f"d{nm}")

    def test_bad_head_counts_raise(self):
        q, k, v = self._args(hq=6, hkv=4)
        with pytest.raises(ValueError, match="multiple of kv heads"):
            flash_attention(q, k, v)
        with pytest.raises(ValueError, match="multiple of kv heads"):
            flash_attention_reference(q, k, v)
        with pytest.raises(ValueError, match="must match"):
            flash_attention(q, k[:, :2], v)

    def test_varlen_gqa(self):
        from flashattn_tpu.ops.flash_attention import flash_attention_varlen

        q, k, v = self._args(seed=2)
        lengths = jnp.asarray([128, 40], jnp.int32)
        got = flash_attention_varlen(q, k, v, lengths, True, impl="triton")
        want = flash_attention_reference(q, k, v, True, kv_lengths=lengths)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)

    @pytest.mark.parametrize("window", [None, 24])
    def test_varlen_gqa_backward(self, window):
        from flashattn_tpu.ops.flash_attention import flash_attention_varlen

        q, k, v = self._args(hq=4, hkv=2, n=96, seed=3)
        lengths = jnp.asarray([96, 33], jnp.int32)
        dy = jax.random.normal(jax.random.PRNGKey(4), q.shape)
        g = jax.grad(lambda a, b, c: jnp.sum(flash_attention_varlen(
            a, b, c, lengths, True, impl="triton", window=window) * dy),
            argnums=(0, 1, 2))(q, k, v)
        gr = jax.grad(lambda a, b, c: jnp.sum(flash_attention_reference(
            a, b, c, True, kv_lengths=lengths, window=window) * dy),
            argnums=(0, 1, 2))(q, k, v)
        for a, b_ in zip(g, gr):
            np.testing.assert_allclose(a, b_, atol=1e-4, rtol=1e-3)


class TestWithLse:
    """flash_attention_with_lse and the blockwise backward ring attention
    runs against the global (o, lse)."""

    @pytest.mark.parametrize("causal", [False, True])
    def test_lse_matches_reference(self, causal):
        q, k, v = _qkv((2, 2, 80, 32), seed=31)
        o, lse = fa.flash_attention_with_lse(q, k, v, causal, impl="triton")
        want_o, want_lse = fa._reference_fwd_with_lse(q, k, v, causal,
                                                      32 ** -0.5)
        assert lse.shape == (2, 2, 80, 1)
        np.testing.assert_allclose(o, want_o, atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(lse, want_lse, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("impl", ["triton", "reference"])
    @pytest.mark.parametrize("window", [None, 20])
    def test_bwd_matches_vjp(self, impl, window):
        ks = jax.random.split(jax.random.PRNGKey(32), 4)
        q = jax.random.normal(ks[0], (1, 4, 64, 16))
        k = jax.random.normal(ks[1], (1, 2, 64, 16))
        v = jax.random.normal(ks[2], (1, 2, 64, 16))
        do = jax.random.normal(ks[3], q.shape)
        o, lse = fa._reference_fwd_with_lse(q, k, v, True, 0.25,
                                            window=window)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, True, impl=impl,
                                     window=window)
        _, vjp = jax.vjp(lambda a, b, c: fa._reference_fwd_with_lse(
            a, b, c, True, 0.25, window=window)[0], q, k, v)
        for a, w in zip(got, vjp(do)):
            np.testing.assert_allclose(a, w, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("impl", ["triton", "reference"])
    def test_blockwise_bwd_sums_to_full(self, impl):
        """Split the kv sequence in two blocks: the backward of each block
        against the GLOBAL (o, lse) sums to the full gradient (the ring)."""
        q, k, v = _qkv((1, 2, 64, 16), seed=33)
        do = jax.random.normal(jax.random.PRNGKey(34), q.shape)
        o, lse = fa._reference_fwd_with_lse(q, k, v, False, 0.25)
        halves = [(k[:, :, :40], v[:, :, :40]), (k[:, :, 40:], v[:, :, 40:])]
        parts = [fa.flash_attention_bwd(q, kb, vb, o, lse, do, False,
                                        sm_scale=0.25, impl=impl)
                 for kb, vb in halves]
        _, vjp = jax.vjp(lambda a, b, c: fa._reference_fwd_with_lse(
            a, b, c, False, 0.25)[0], q, k, v)
        dq, dk, dv = vjp(do)
        np.testing.assert_allclose(parts[0][0] + parts[1][0], dq, atol=1e-4)
        np.testing.assert_allclose(
            jnp.concatenate([parts[0][1], parts[1][1]], 2), dk, atol=1e-4)
        np.testing.assert_allclose(
            jnp.concatenate([parts[0][2], parts[1][2]], 2), dv, atol=1e-4)


class TestPadding:
    """Head dims and sequence lengths off the power-of-two tiles."""

    @pytest.mark.parametrize("d", [8, 24, 40])
    def test_head_dims_fwd_and_grad(self, d):
        q, k, v = _qkv((1, 2, 40, d), seed=41 + d)
        got = flash_attention(q, k, v, True)
        np.testing.assert_allclose(got, flash_attention_reference(
            q, k, v, True), atol=2e-5, rtol=1e-4)
        g = jax.grad(lambda a: jnp.sum(flash_attention(a, k, v, True)))(q)
        gr = jax.grad(lambda a: jnp.sum(flash_attention_reference(
            a, k, v, True)))(q)
        np.testing.assert_allclose(g, gr, atol=1e-4, rtol=1e-3)

    def test_varlen_ragged_kv(self):
        q, k, v = _qkv((2, 2, 30, 16), seed=45, kv_len=70)
        lengths = jnp.asarray([70, 23], jnp.int32)
        got = fa.flash_attention_varlen(q, k, v, lengths, False,
                                        impl="triton")
        want = flash_attention_reference(q, k, v, False, kv_lengths=lengths)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)

    def test_bf16_inputs(self):
        q, k, v = (t.astype(jnp.bfloat16) for t in _qkv((1, 2, 64, 32),
                                                         seed=46))
        got = flash_attention(q, k, v, True)
        assert got.dtype == jnp.bfloat16
        want = flash_attention_reference(*(t.astype(jnp.float32)
                                           for t in (q, k, v)), True)
        np.testing.assert_allclose(np.asarray(got, np.float32), want,
                                   atol=2e-2)


class TestCudnnArguments:
    """The cuDNN route's argument mapping (layout transposes, window and
    length conventions), run through jax.nn.dot_product_attention's XLA
    implementation, which takes the same arguments."""

    def _xla(self, q, k, v, lengths, causal, window, with_lse=False):
        return fa._cudnn_attention(q, k, v, lengths, causal,
                                   q.shape[-1] ** -0.5, window, with_lse,
                                   implementation="xla")

    @pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                               (True, 9)])
    def test_dense_and_window(self, causal, window):
        ks = jax.random.split(jax.random.PRNGKey(51), 3)
        q = jax.random.normal(ks[0], (2, 4, 32, 16))
        k = jax.random.normal(ks[1], (2, 2, 32, 16))
        v = jax.random.normal(ks[2], (2, 2, 32, 16))
        np.testing.assert_allclose(
            self._xla(q, k, v, None, causal, window),
            flash_attention_reference(q, k, v, causal, window=window),
            atol=2e-5, rtol=1e-4)

    def test_varlen_rows_without_keys_are_zero(self):
        q, k, v = _qkv((3, 2, 32, 16), seed=52)
        lengths = jnp.asarray([32, 6, 0], jnp.int32)
        got = self._xla(q, k, v, lengths, True, 4)
        want = flash_attention_reference(q, k, v, True, kv_lengths=lengths,
                                         window=4)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)

    def test_lse_layout(self):
        q, k, v = _qkv((1, 2, 24, 16), seed=53)
        o, lse = self._xla(q, k, v, None, True, None, with_lse=True)
        want_o, want_lse = fa._reference_fwd_with_lse(q, k, v, True, 0.25)
        assert lse.shape == want_lse.shape
        np.testing.assert_allclose(o, want_o, atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(lse, want_lse, atol=1e-4, rtol=1e-4)


class TestDispatch:
    """choose_impl: the route per role, shape, dtype and platform."""

    def _ok(self, role, dtype, nq=2048, nk=2048, d=128, causal=True,
            impl="auto", platform="gpu"):
        q = jax.ShapeDtypeStruct((1, 4, nq, d), dtype)
        k = jax.ShapeDtypeStruct((1, 4, nk, d), dtype)
        return fa.choose_impl(role, q, k, causal, None, impl, platform)

    @pytest.mark.parametrize("role", ["dense", "varlen"])
    @pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16])
    def test_gpu_half_precision_takes_cudnn(self, role, dtype):
        assert self._ok(role, dtype) == "cudnn"

    def test_gpu_f32_takes_triton(self):
        """f32 takes Triton only where the lse is returned (ring attention);
        dense and varlen f32 take the XLA graph (test below)."""
        assert self._ok("with_lse", jnp.float32) == "triton"

    @pytest.mark.parametrize("role", ["dense", "varlen"])
    @pytest.mark.parametrize("d", [128, 20])
    def test_gpu_f32_dense_and_varlen_take_reference(self, role, d):
        assert self._ok(role, jnp.float32, d=d) == "reference"
        assert self._ok(role, jnp.float32, nq=64, nk=256) == "reference"

    def test_gpu_with_lse_takes_triton(self):
        assert self._ok("with_lse", jnp.bfloat16) == "triton"

    @pytest.mark.parametrize("d", [20, 256])
    def test_gpu_head_dim_off_cudnn_grid_takes_triton(self, d):
        assert self._ok("dense", jnp.bfloat16, d=d) == "triton"

    def test_gpu_causal_cross_attention_takes_triton(self):
        assert self._ok("dense", jnp.bfloat16, nq=64, nk=256) == "triton"
        assert self._ok("dense", jnp.bfloat16, nq=64, nk=256,
                        causal=False) == "cudnn"

    @pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
    def test_cpu_takes_reference(self, dtype):
        assert self._ok("dense", dtype, platform="cpu") == "reference"

    def test_explicit_impl_is_honoured_and_checked(self):
        assert self._ok("dense", jnp.float32, impl="cudnn") == "cudnn"
        assert self._ok("dense", jnp.bfloat16, impl="reference",
                        platform="gpu") == "reference"
        with pytest.raises(ValueError, match="impl must be one of"):
            self._ok("dense", jnp.float32, impl="pallas")

    def test_window_requires_causal_on_every_entry(self):
        q, k, v = _qkv((1, 1, 16, 16))
        for fn in (lambda: fa.flash_attention(q, k, v, False, window=4),
                   lambda: fa.flash_attention_with_lse(q, k, v, False,
                                                       window=4)):
            with pytest.raises(ValueError, match="requires causal"):
                fn()
