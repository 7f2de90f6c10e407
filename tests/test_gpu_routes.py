"""The kernel routes compiled for the card, against the plain reference.

Interpret mode (the rest of the suite) checks the kernels' arithmetic on the
CPU; these tests check what only the card can: that Triton and cuDNN
compile the routes and agree with the reference.  They skip without a GPU
and are run by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled Triton/cuDNN routes "
                    "(run by chip_smoke.py)")
    return jax


def _qkv(jax, b, h, h_kv, n, d, dtype, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    return (jax.random.normal(ks[0], (b, h, n, d), dtype),
            jax.random.normal(ks[1], (b, h_kv, n, d), dtype),
            jax.random.normal(ks[2], (b, h_kv, n, d), dtype),
            jax.random.normal(ks[3], (b, h, n, d), dtype))


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    err = np.max(np.abs(got - want))
    assert err <= tol * max(1.0, np.max(np.abs(want))), err


@pytest.mark.parametrize("route", ["triton", "cudnn"])
@pytest.mark.parametrize("window", [None, 96])
def test_flash_route_fwd_and_grad(gpu, route, window):
    from flashattn_tpu.ops.flash_attention import (flash_attention,
                                                   flash_attention_reference)

    jax = gpu
    q, k, v, dy = _qkv(jax, 2, 8, 2, 512, 64, jnp.bfloat16)

    def loss(fn):
        return lambda a, b, c: jnp.sum(fn(a, b, c).astype(jnp.float32) * dy)

    got = jax.jit(lambda a, b, c: flash_attention(a, b, c, True, impl=route,
                                                  window=window))
    want = lambda a, b, c: flash_attention_reference(  # noqa: E731
        a.astype(jnp.float32), b.astype(jnp.float32), c.astype(jnp.float32),
        True, window=window)
    with jax.default_matmul_precision("highest"):
        ref_o = want(q, k, v)
        ref_g = jax.grad(loss(want), argnums=(0, 1, 2))(q, k, v)
    _close(got(q, k, v), ref_o, 2e-2)
    for a, b in zip(jax.jit(jax.grad(loss(got), argnums=(0, 1, 2)))(q, k, v),
                    ref_g):
        _close(a, b, 2e-2)


@pytest.mark.parametrize("route,window", [("triton", None), ("cudnn", None),
                                          ("cudnn", 64)])
def test_varlen_route(gpu, route, window):
    from flashattn_tpu.ops.flash_attention import (flash_attention_reference,
                                                   flash_attention_varlen)

    jax = gpu
    q, k, v, _ = _qkv(jax, 3, 4, 4, 384, 128, jnp.bfloat16, seed=1)
    lengths = jnp.asarray([384, 200, 0], jnp.int32)
    got = jax.jit(lambda *a: flash_attention_varlen(
        *a, lengths, True, impl=route, window=window))(q, k, v)
    with jax.default_matmul_precision("highest"):
        want = flash_attention_reference(
            *(t.astype(jnp.float32) for t in (q, k, v)), True,
            kv_lengths=lengths, window=window)
    _close(got, want, 2e-2)
    assert float(jnp.abs(got[2]).max()) == 0.0


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float8_e4m3fn"])
def test_paged_triton(gpu, dtype):
    from flashattn_tpu.models.transformer import _quantize_kv
    from flashattn_tpu.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    jax = gpu
    b, hq, hkv, d, page, pps = 4, 8, 2, 128, 64, 16
    ks = jax.random.split(jax.random.PRNGKey(2), 3)
    kp = jax.random.normal(ks[0], (hkv, b * pps, page, d), jnp.bfloat16)
    vp = jax.random.normal(ks[1], (hkv, b * pps, page, d), jnp.bfloat16)
    kw = {}
    if dtype != "bfloat16":
        kp, ksc = _quantize_kv(kp, jnp.dtype(dtype))
        vp, vsc = _quantize_kv(vp, jnp.dtype(dtype))
        kw = dict(k_scales=ksc, v_scales=vsc)
    table = jnp.asarray(np.random.default_rng(0).permutation(b * pps)
                        .reshape(b, pps), jnp.int32)
    lengths = jnp.asarray([1, 300, 777, 1024], jnp.int32)
    q = jax.random.normal(ks[2], (b, hq, d), jnp.bfloat16)
    got = jax.jit(lambda *a: paged_attention(*a, impl="triton", **kw))(
        q, kp, vp, lengths, table)
    want = paged_attention_reference(q, kp, vp, lengths, table, **kw)
    _close(got, want, 2e-2)
