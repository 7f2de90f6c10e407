"""FlashAttention forward/backward for the GPU.

The reference's core contribution (``src/flashattention_kernel.cu``: fw
``forward_kernel:9-112`` / ``forward_kernel_causal:438-545``, bw
``backward_kernel:115-255`` / ``backward_kernel_causal:547-690``) is a flash
kernel: Q, K and V tiles staged through shared memory, an online softmax
carrying (m, l), causal attention skipping whole tiles above the diagonal
(``:511-515``) and a backward that recomputes P from the saved lse.  Three
routes implement the same semantics here, chosen per call by
:func:`choose_impl`:

* ``"triton"`` -- this module's own Pallas kernels, compiled through Triton.
  One program per (q-block, batch, head); K/V tiles are looped through shared
  memory with the loop bounded at the diagonal, the window and the row's
  valid length; GQA by index (query head ``h`` reads kv head ``h // group``).
  The backward is two kernels (dQ, then dK/dV per kv head summing its query
  group), with no atomics, against a given (o, lse) -- which is also what
  ring attention needs for its blockwise backward.
* ``"cudnn"`` -- cuDNN's fused attention through
  ``jax.nn.dot_product_attention(implementation="cudnn")``: bf16/fp16 only,
  and it takes ``(B, T, N, H)``, so each call is wrapped in a transpose pair.
* ``"reference"`` -- the XLA op graph (:func:`_reference_fwd_with_lse`),
  which materialises the score matrix.

Every entry takes ``(batch, heads, seq, head_dim)``.  Masking conventions
shared by all routes: causal is top-left aligned (row ``i`` attends columns
``<= i``); ``window`` keeps columns ``(i - window, i]``; ``kv_lengths`` masks
keys at positions ``>= kv_lengths[b]``; a row with no live key outputs 0 and
has ``lse = -inf``.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ._utils import DEFAULT_MASK_VALUE, round_up, use_interpret_mode

Array = jax.Array


def _idiv(a, b):
    """Integer division of traced int32 scalars (lax.div wants one dtype;
    python ints and x64 mode would otherwise mix int32 and int64)."""
    return lax.div(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))

# The kernels run the online softmax in base 2: log2(e) is folded into the
# score scale once, so m lives in the scaled domain and the natural-log lse
# is recovered as (m + log2(l)) * ln(2).
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

IMPLS = ("auto", "reference", "triton", "cudnn")

# Triton tiles (powers of two; the dot wants every dim >= 16) and launch
# parameters, from a sweep on the H100 at B8 H16 N2048 D128 causal bf16
# (PERF.md): forward 64x64 tiles, 4 warps, 3 stages (238 TF/s; 128x64 with
# 8 warps, 2 stages: 181); backward 64x64, 4 warps, 2 stages (fastest of
# the five tried).
_FWD_BLOCK_Q, _FWD_BLOCK_K, _FWD_STAGES = 64, 64, 3
_BWD_BLOCK_Q, _BWD_BLOCK_K, _BWD_STAGES = 64, 64, 2
_NUM_WARPS = 4


def _block(n: int, target: int) -> int:
    return max(16, min(target, pl.next_power_of_2(n)))


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------


def _live(rows, cols, kv_len, causal, window):
    """(rows, cols) mask of the keys each query row may attend."""
    keep = cols[None, :] < kv_len
    if causal:
        keep &= cols[None, :] <= rows[:, None]
    if window is not None:
        keep &= cols[None, :] > rows[:, None] - window
    return keep


def _kv_block_range(q_start, q_rows, kv_len, block_k, causal, window):
    """[lo, hi) of the kv blocks a q block [q_start, q_start + q_rows) can
    see: bounded by the row's valid length, the diagonal and the window."""
    hi = _idiv(kv_len + block_k - 1, block_k)
    if causal:
        hi = jnp.minimum(hi, _idiv(q_start + q_rows + block_k - 1, block_k))
    lo = jnp.int32(0)
    if window is not None:
        lo = _idiv(jnp.maximum(q_start - window + 1, 0), block_k)
    return lo, hi


def _fwd_kernel(q_ref, k_ref, v_ref, len_ref, o_ref, lse_ref, *,
                scale, causal, window, block_q, block_k):
    qi = pl.program_id(0)
    q_start = qi * block_q
    kv_len = len_ref[0]
    q = q_ref[...]
    rows = q_start + jnp.arange(block_q)
    d = q.shape[-1]

    def body(j, carry):
        acc, m, l = carry
        start = j * block_k
        k = k_ref[pl.ds(start, block_k), :]
        v = v_ref[pl.ds(start, block_k), :]
        s = pl.dot(q, k.T) * (scale * LOG2E)
        keep = _live(rows, start + jnp.arange(block_k), kv_len, causal, window)
        s = jnp.where(keep, s, DEFAULT_MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.where(keep, jnp.exp2(s - m_new[:, None]), 0.0)
        l = alpha * l + jnp.sum(p, axis=1)
        acc = acc * alpha[:, None] + pl.dot(p.astype(v.dtype), v)
        return acc, m_new, l

    lo, hi = _kv_block_range(q_start, block_q, kv_len, block_k, causal, window)
    acc = jnp.zeros((block_q, d), jnp.float32)
    m = jnp.full((block_q,), DEFAULT_MASK_VALUE, jnp.float32)
    l = jnp.zeros((block_q,), jnp.float32)
    acc, m, l = lax.fori_loop(lo, hi, body, (acc, m, l))
    empty = l == 0.0
    l_safe = jnp.where(empty, 1.0, l)
    o_ref[...] = (acc / l_safe[:, None]).astype(o_ref.dtype)
    lse_ref[...] = jnp.where(empty, -jnp.inf, (m + jnp.log2(l_safe)) * LN2)


def _dq_kernel(q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref, len_ref,
               dq_ref, *, scale, causal, window, block_q, block_k):
    qi = pl.program_id(0)
    q_start = qi * block_q
    kv_len = len_ref[0]
    q = q_ref[...]
    do = do_ref[...]
    lse2 = lse_ref[...]
    delta = delta_ref[...]
    rows = q_start + jnp.arange(block_q)

    def body(j, dq):
        start = j * block_k
        k = k_ref[pl.ds(start, block_k), :]
        v = v_ref[pl.ds(start, block_k), :]
        s = pl.dot(q, k.T) * (scale * LOG2E)
        keep = _live(rows, start + jnp.arange(block_k), kv_len, causal, window)
        p = jnp.where(keep, jnp.exp2(s - lse2[:, None]), 0.0)
        dp = pl.dot(do, v.T)
        ds = p * (dp - delta[:, None])
        return dq + pl.dot(ds.astype(k.dtype), k)

    lo, hi = _kv_block_range(q_start, block_q, kv_len, block_k, causal, window)
    dq = jnp.zeros(q.shape, jnp.float32)
    dq = lax.fori_loop(lo, hi, body, dq)
    dq_ref[...] = (dq * scale).astype(dq_ref.dtype)


def _dkv_kernel(q_ref, k_ref, v_ref, do_ref, lse_ref, delta_ref, len_ref,
                dk_ref, dv_ref, *, scale, causal, window, block_q, block_k,
                n_q, group):
    """One kv block of one kv head: walks the q blocks of every query head
    in its group (rows laid out (group, n_q)) and sums their dK/dV."""
    kj = pl.program_id(0)
    k_start = kj * block_k
    kv_len = len_ref[0]
    k = k_ref[...]
    v = v_ref[...]
    cols = k_start + jnp.arange(block_k)

    n_qb = n_q // block_q
    lo = jnp.int32(0)
    hi = jnp.int32(n_qb)
    if causal:
        lo = _idiv(k_start, block_q)
    if window is not None:
        hi = jnp.minimum(hi, _idiv(k_start + block_k + window - 2 + block_q,
                                     block_q))
    hi = jnp.where(k_start < kv_len, jnp.maximum(hi, lo), lo)
    per_g = hi - lo

    def body(t, carry):
        dk, dv = carry
        g = _idiv(t, per_g)
        qb = lo + t - g * per_g
        q_start = qb * block_q
        sl = pl.ds(g * n_q + q_start, block_q)
        q = q_ref[sl, :]
        do = do_ref[sl, :]
        lse2 = lse_ref[sl]
        delta = delta_ref[sl]
        rows = q_start + jnp.arange(block_q)
        s = pl.dot(q, k.T) * (scale * LOG2E)
        keep = _live(rows, cols, kv_len, causal, window)
        p = jnp.where(keep, jnp.exp2(s - lse2[:, None]), 0.0)
        dv = dv + pl.dot(p.astype(do.dtype).T, do)
        dp = pl.dot(do, v.T)
        ds = p * (dp - delta[:, None])
        dk = dk + pl.dot(ds.astype(q.dtype).T, q)
        return dk, dv

    dk = jnp.zeros(k.shape, jnp.float32)
    dv = jnp.zeros(v.shape, jnp.float32)
    dk, dv = lax.fori_loop(0, per_g * group, body, (dk, dv))
    dk_ref[...] = (dk * scale).astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


def _pad_to(t, n: int, d: int):
    pn, pd = n - t.shape[2], d - t.shape[3]
    if pn == 0 and pd == 0:
        return t
    return jnp.pad(t, ((0, 0), (0, 0), (0, pn), (0, pd)))


def _kv_lengths_or_full(kv_lengths, b, n_kv):
    if kv_lengths is None:
        return jnp.full((b,), n_kv, jnp.int32)
    return jnp.minimum(kv_lengths.astype(jnp.int32), n_kv)


def _triton_fwd(q, k, v, kv_lengths, causal, scale, window):
    """Returns (o, lse) with lse shaped (b, h, n_q, 1)."""
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    group = h // h_kv
    bq, bk = _block(n_q, _FWD_BLOCK_Q), _block(n_kv, _FWD_BLOCK_K)
    nq_p, nk_p = round_up(n_q, bq), round_up(n_kv, bk)
    d_p = max(16, pl.next_power_of_2(d))
    qp = _pad_to(q, nq_p, d_p)
    kp, vp = _pad_to(k, nk_p, d_p), _pad_to(v, nk_p, d_p)
    lens = _kv_lengths_or_full(kv_lengths, b, n_kv)
    kernel = functools.partial(_fwd_kernel, scale=scale, causal=causal,
                               window=window, block_q=bq, block_k=bk)
    o, lse = pl.pallas_call(
        kernel,
        grid=(nq_p // bq, b, h),
        in_specs=[
            pl.BlockSpec((None, None, bq, d_p), lambda i, b_, h_: (b_, h_, i, 0)),
            pl.BlockSpec((None, None, nk_p, d_p),
                         lambda i, b_, h_: (b_, h_ // group, 0, 0)),
            pl.BlockSpec((None, None, nk_p, d_p),
                         lambda i, b_, h_: (b_, h_ // group, 0, 0)),
            pl.BlockSpec((1,), lambda i, b_, h_: (b_,)),
        ],
        out_specs=[
            pl.BlockSpec((None, None, bq, d_p), lambda i, b_, h_: (b_, h_, i, 0)),
            pl.BlockSpec((None, None, bq), lambda i, b_, h_: (b_, h_, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, h, nq_p, d_p), q.dtype),
            jax.ShapeDtypeStruct((b, h, nq_p), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_FWD_STAGES),
        backend="triton",
        interpret=use_interpret_mode(),
        name="flash_fwd",
    )(qp, kp, vp, lens)
    return o[:, :, :n_q, :d], lse[:, :, :n_q, None]


def _triton_bwd(q, k, v, o, lse, do, kv_lengths, causal, scale, window):
    """dq, dk, dv of the attention whose output and log-sum-exp are the
    given (o, lse) -- the global ones in ring attention."""
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    group = h // h_kv
    bq, bk = _block(n_q, _BWD_BLOCK_Q), _block(n_kv, _BWD_BLOCK_K)
    nq_p, nk_p = round_up(n_q, bq), round_up(n_kv, bk)
    d_p = max(16, pl.next_power_of_2(d))
    lens = _kv_lengths_or_full(kv_lengths, b, n_kv)
    delta = jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32), axis=-1)
    lse2 = lse[..., 0] * LOG2E
    # an empty row (lse = -inf) must give p = 0, not exp2(+inf)
    lse2 = jnp.where(jnp.isneginf(lse2), jnp.inf, lse2)
    pad_rows = ((0, 0), (0, 0), (0, nq_p - n_q))
    lse2 = jnp.pad(lse2, pad_rows)
    delta = jnp.pad(delta, pad_rows)
    qp, dop = _pad_to(q, nq_p, d_p), _pad_to(do, nq_p, d_p)
    kp, vp = _pad_to(k, nk_p, d_p), _pad_to(v, nk_p, d_p)
    kw = dict(scale=scale, causal=causal, window=window)
    params = plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                  num_stages=_BWD_STAGES)
    row = lambda i, b_, h_: (b_, h_, i, 0)   # noqa: E731
    kv_of_q = lambda i, b_, h_: (b_, h_ // group, 0, 0)   # noqa: E731

    dq = pl.pallas_call(
        functools.partial(_dq_kernel, block_q=bq, block_k=bk, **kw),
        grid=(nq_p // bq, b, h),
        in_specs=[
            pl.BlockSpec((None, None, bq, d_p), row),
            pl.BlockSpec((None, None, nk_p, d_p), kv_of_q),
            pl.BlockSpec((None, None, nk_p, d_p), kv_of_q),
            pl.BlockSpec((None, None, bq, d_p), row),
            pl.BlockSpec((None, None, bq), lambda i, b_, h_: (b_, h_, i)),
            pl.BlockSpec((None, None, bq), lambda i, b_, h_: (b_, h_, i)),
            pl.BlockSpec((1,), lambda i, b_, h_: (b_,)),
        ],
        out_specs=pl.BlockSpec((None, None, bq, d_p), row),
        out_shape=jax.ShapeDtypeStruct((b, h, nq_p, d_p), q.dtype),
        compiler_params=params,
        backend="triton",
        interpret=use_interpret_mode(),
        name="flash_bwd_dq",
    )(qp, kp, vp, dop, lse2, delta, lens)

    # query heads of one kv head are adjacent: (b, h_kv, group * nq_p, d)
    # is a free reshape, and the dK/dV program walks all of its group's rows
    grp = lambda t: t.reshape(b, h_kv, group * nq_p, *t.shape[3:])  # noqa: E731
    gspec = pl.BlockSpec((None, None, group * nq_p, d_p),
                         lambda j, b_, g_: (b_, g_, 0, 0))
    gvec = pl.BlockSpec((None, None, group * nq_p), lambda j, b_, g_: (b_, g_, 0))
    kv_blk = pl.BlockSpec((None, None, bk, d_p), lambda j, b_, g_: (b_, g_, j, 0))
    dk, dv = pl.pallas_call(
        functools.partial(_dkv_kernel, block_q=bq, block_k=bk, n_q=nq_p,
                          group=group, **kw),
        grid=(nk_p // bk, b, h_kv),
        in_specs=[gspec, kv_blk, kv_blk, gspec, gvec, gvec,
                  pl.BlockSpec((1,), lambda j, b_, g_: (b_,))],
        out_specs=[kv_blk, kv_blk],
        out_shape=[jax.ShapeDtypeStruct((b, h_kv, nk_p, d_p), k.dtype),
                   jax.ShapeDtypeStruct((b, h_kv, nk_p, d_p), v.dtype)],
        compiler_params=params,
        backend="triton",
        interpret=use_interpret_mode(),
        name="flash_bwd_dkv",
    )(grp(qp), kp, vp, grp(dop), grp(lse2), grp(delta), lens)
    return (dq[:, :, :n_q, :d], dk[:, :, :n_kv, :d], dv[:, :, :n_kv, :d])


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def _triton_attention(q, k, v, kv_lengths, causal, scale, window):
    return _triton_fwd(q, k, v, kv_lengths, causal, scale, window)[0]


def _triton_vjp_fwd(q, k, v, kv_lengths, causal, scale, window):
    o, lse = _triton_fwd(q, k, v, kv_lengths, causal, scale, window)
    return o, (q, k, v, kv_lengths, o, lse)


def _triton_vjp_bwd(causal, scale, window, res, do):
    q, k, v, kv_lengths, o, lse = res
    dq, dk, dv = _triton_bwd(q, k, v, o, lse, do, kv_lengths, causal, scale,
                             window)
    return dq, dk, dv, None


_triton_attention.defvjp(_triton_vjp_fwd, _triton_vjp_bwd)


# ---------------------------------------------------------------------------
# cuDNN route
# ---------------------------------------------------------------------------


def _to_btnh(t):
    return t.transpose(0, 2, 1, 3)


def _cudnn_attention(q, k, v, kv_lengths, causal, scale, window,
                     with_lse=False, implementation="cudnn"):
    """cuDNN's fused attention in this module's layout and conventions
    (``implementation="xla"`` runs the same call through XLA, which is how
    the CPU tests pin the argument mapping)."""
    out = jax.nn.dot_product_attention(
        _to_btnh(q), _to_btnh(k), _to_btnh(v), scale=scale, is_causal=causal,
        key_value_seq_lengths=(None if kv_lengths is None
                               else kv_lengths.astype(jnp.int32)),
        local_window_size=None if window is None else (window - 1, 0),
        implementation=implementation, return_residual=with_lse)
    if with_lse:
        o, lse = out                  # lse: (B, T, N)
        return _to_btnh(o), lse.astype(jnp.float32).transpose(0, 2, 1)[..., None]
    out = _to_btnh(out)
    if kv_lengths is not None:
        # a row with no live key outputs 0, as on the other routes: every
        # row of an empty sequence, and under a window the rows whose
        # window has slid past the sequence's last key
        live = jnp.broadcast_to((kv_lengths > 0)[:, None],
                                (q.shape[0], q.shape[2]))
        if window is not None:
            rows = jnp.arange(q.shape[2])
            live &= rows[None, :] < kv_lengths[:, None] + window - 1
        out = jnp.where(live[:, None, :, None], out, 0)
    return out


# ---------------------------------------------------------------------------
# XLA op-graph route (and the oracle)
# ---------------------------------------------------------------------------


def repeat_kv(k: Array, v: Array, n_q_heads: int):
    """Broadcast GQA/MQA kv heads up to ``n_q_heads`` query heads.

    THE head-order convention: query head ``h`` reads kv head ``h // group``
    with ``group = n_q_heads // n_kv_heads`` -- the same folding the kernels
    apply in their kv index maps and the dK/dV kernel applies in its group
    sum.  Every op-graph path must broadcast through this helper so the
    convention is pinned in one place.
    """
    group = n_q_heads // k.shape[1]
    if group == 1:
        return k, v
    return jnp.repeat(k, group, axis=1), jnp.repeat(v, group, axis=1)


def _check_heads(q, k, v):
    h, h_kv = q.shape[1], k.shape[1]
    if v.shape[1] != h_kv:
        raise ValueError(
            f"k has {h_kv} heads but v has {v.shape[1]}; they must match")
    if h_kv == 0 or h % h_kv != 0:
        raise ValueError(
            f"q heads ({h}) must be a positive multiple of kv heads "
            f"({h_kv}) for GQA/MQA grouping")


def _check_window(causal, window):
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window attention) requires "
                             "causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def _reference_fwd_with_lse(q, k, v, causal, scale, kv_lengths=None,
                            window=None):
    k, v = repeat_kv(k, v, q.shape[1])  # GQA/MQA broadcast
    # preferred_element_type keeps bf16 scores in f32 end-to-end -- without
    # it the einsum rounds s to bf16 and the oracle is less accurate than the
    # kernels.
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                   preferred_element_type=jnp.float32) * scale
    keep = None
    if causal:
        nq, nk = s.shape[-2:]
        keep = jnp.arange(nk)[None, :] <= jnp.arange(nq)[:, None]
        if window is not None:
            keep &= jnp.arange(nk)[None, :] > jnp.arange(nq)[:, None] - window
        s = jnp.where(keep, s, DEFAULT_MASK_VALUE)
    if kv_lengths is not None:
        nk = s.shape[-1]
        valid = jnp.arange(nk)[None, None, None, :] < kv_lengths[:, None, None, None]
        s = jnp.where(valid, s, DEFAULT_MASK_VALUE)
        keep = valid if keep is None else (keep & valid)
    m = jnp.max(s, axis=-1, keepdims=True)
    e = jnp.exp(s - m)
    if keep is not None and kv_lengths is not None:
        # Rows with NO live keys output 0.  The zeroing must use the
        # COMBINED mask: a short varlen row whose in-prefix keys are all
        # outside the sliding window has m == MASK, making every masked e
        # equal 1.
        e = jnp.where(keep, e, 0.0)
    l = jnp.sum(e, axis=-1, keepdims=True)
    l_safe = jnp.where(l == 0.0, 1.0, l)
    o = jnp.einsum("bhqk,bhkd->bhqd", (e / l_safe).astype(v.dtype), v,
                   preferred_element_type=jnp.float32)
    lse = jnp.where(l == 0.0, -jnp.inf, m + jnp.log(l_safe))
    return o.astype(q.dtype), lse


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def choose_impl(role: str, q, k, causal: bool, window: Optional[int] = None,
                impl: str = "auto", platform: Optional[str] = None) -> str:
    """The route one call takes.  ``role`` is ``"dense"``, ``"varlen"`` or
    ``"with_lse"``; ``platform`` defaults to JAX's backend.

    ``impl`` other than ``"auto"`` is honoured as given.  On the CPU "auto"
    is the XLA op graph: the Pallas interpreter there is a test vehicle, not
    a route.  On the GPU the choice follows the H100 measurements in
    PERF.md: cuDNN for bf16/fp16 dense and varlen self-attention with a head
    dim it takes, where it beats both other routes; the XLA op graph for f32
    dense and varlen, whose forward + backward beats the Triton kernels'
    (and which honours ``jax.default_matmul_precision``; the Triton dots run
    in TF32); this module's Triton kernels for what remains: the f32 lse
    that ring attention merges (cuDNN returns it in the input dtype) and its
    blockwise backward, head dims off cuDNN's grid, and causal
    cross-attention, whose diagonal cuDNN aligns differently.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    platform = platform or jax.default_backend()
    if platform != "gpu":
        return "reference"
    if role in ("dense", "varlen") and q.dtype == jnp.float32:
        return "reference"
    d = q.shape[-1]
    if (role in ("dense", "varlen") and q.dtype in (jnp.bfloat16, jnp.float16)
            and k.dtype == q.dtype and d % 8 == 0 and d <= 128
            and not (causal and q.shape[2] != k.shape[2])):
        return "cudnn"
    return "triton"


def _scale_of(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def _attention(role, q, k, v, kv_lengths, causal, sm_scale, impl, window):
    _check_heads(q, k, v)
    _check_window(causal, window)
    scale = _scale_of(q, sm_scale)
    route = choose_impl(role, q, k, causal, window, impl)
    if route == "reference":
        return _reference_fwd_with_lse(q, k, v, causal, scale, kv_lengths,
                                       window)[0]
    if route == "cudnn":
        return _cudnn_attention(q, k, v, kv_lengths, causal, scale, window)
    return _triton_attention(q, k, v, kv_lengths, causal, scale, window)


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------


def flash_attention(
    q: Array,
    k: Array,
    v: Array,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
    window: Optional[int] = None,
) -> Array:
    """softmax(Q K^T * scale) V, differentiable.

    Args:
      q, k, v: (batch, heads, seq, head_dim); kv seq may differ from q seq
        and kv heads may divide q heads (GQA/MQA).
      causal: apply the triangular future mask (reference
        ``flash_attention_causal``, tensor_functions.py:501-516).
      sm_scale: score scale; defaults to 1/sqrt(head_dim)
        (flashattention_kernel.cu:278).
      impl: "auto" (see :func:`choose_impl`), "triton", "cudnn" or
        "reference".
      window: sliding-window (local) attention -- row i attends cols
        (i - window, i].  Requires ``causal=True``.

    Returns: (batch, heads, seq_q, head_dim).
    """
    return _attention("dense", q, k, v, None, causal, sm_scale, impl, window)


def flash_attention_varlen(
    q: Array, k: Array, v: Array, kv_lengths: Array,
    causal: bool = False, sm_scale: Optional[float] = None,
    impl: str = "auto", window: Optional[int] = None,
) -> Array:
    """Flash attention over a PADDED batch: ``kv_lengths`` (B,) int32 gives
    each row's valid KV prefix; keys/values at positions >= length are
    masked out of the softmax in-kernel, and the kernel's kv loop stops at
    the length (no (B,H,Nq,Nkv) mask materialised -- the capability the
    reference's fused softmax provides via an additive HBM mask,
    softmax_kernel.cu:232-292).

    Serves batched prefill and padded-batch training.  Differentiable in
    q/k/v.  ``window`` composes sliding-window attention with the varlen
    masking; requires causal.
    """
    return _attention("varlen", q, k, v, kv_lengths, causal, sm_scale, impl,
                      window)


def flash_attention_with_lse(
    q: Array, k: Array, v: Array, causal: bool = False,
    sm_scale: Optional[float] = None, impl: str = "auto",
    window: Optional[int] = None,
):
    """Forward-only flash attention returning ``(o, lse)`` with lse shaped
    (b, h, n_q, 1) in f32.

    The log-sum-exp residual is what ring attention / context parallelism
    needs to merge partial results across sequence shards -- the same
    (m, l) statistics the reference writes back to HBM
    (flashattention_kernel.cu:107-108), in FA-2 combined form.
    """
    _check_heads(q, k, v)
    _check_window(causal, window)
    scale = _scale_of(q, sm_scale)
    route = choose_impl("with_lse", q, k, causal, window, impl)
    if route == "reference":
        return _reference_fwd_with_lse(q, k, v, causal, scale, window=window)
    if route == "cudnn":
        return _cudnn_attention(q, k, v, None, causal, scale, window,
                                with_lse=True)
    return _triton_fwd(q, k, v, None, causal, scale, window)


def flash_attention_bwd(q: Array, k: Array, v: Array, o: Array, lse: Array,
                        do: Array, causal: bool = False,
                        sm_scale: Optional[float] = None, impl: str = "auto",
                        kv_lengths: Optional[Array] = None,
                        window: Optional[int] = None):
    """(dq, dk, dv) of one (q, kv) block pair against a GIVEN output and
    log-sum-exp: recomputes P = exp(S - lse) blockwise.  With the global
    (o, lse) of a ring, the sum of these over all kv blocks is the exact
    gradient (the blockwise-parallel backward).  Routes: "triton" (the dQ
    and dK/dV kernels) or "reference" (the same recomputation in XLA)."""
    _check_heads(q, k, v)
    scale = _scale_of(q, sm_scale)
    route = choose_impl("with_lse", q, k, causal, window, impl)
    if route == "triton":
        return _triton_bwd(q, k, v, o, lse, do, kv_lengths, causal, scale,
                           window)
    return _reference_bwd(q, k, v, o, lse, do, kv_lengths, causal, scale,
                          window)


def _reference_bwd(q, k, v, o, lse, do, kv_lengths, causal, scale, window):
    h_kv = k.shape[1]
    kr, vr = repeat_kv(k, v, q.shape[1])
    f32 = jnp.float32
    s = jnp.einsum("bhqd,bhkd->bhqk", q, kr, preferred_element_type=f32) * scale
    nq, nk = s.shape[-2:]
    rows, cols = jnp.arange(nq), jnp.arange(nk)
    lens = _kv_lengths_or_full(kv_lengths, q.shape[0], nk)
    keep = cols[None, None, None, :] < lens[:, None, None, None]
    if causal:
        keep &= cols[None, :] <= rows[:, None]
    if window is not None:
        keep &= cols[None, :] > rows[:, None] - window
    lse_safe = jnp.where(jnp.isneginf(lse), jnp.inf, lse)
    p = jnp.where(keep, jnp.exp(s - lse_safe), 0.0)
    do32 = do.astype(f32)
    delta = jnp.sum(o.astype(f32) * do32, axis=-1, keepdims=True)
    dv = jnp.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = jnp.einsum("bhqd,bhkd->bhqk", do32, vr.astype(f32))
    ds = p * (dp - delta) * scale
    dq = jnp.einsum("bhqk,bhkd->bhqd", ds, kr.astype(f32))
    dk = jnp.einsum("bhqk,bhqd->bhkd", ds, q.astype(f32))
    b, h = q.shape[:2]
    fold = lambda t: t.reshape(b, h_kv, h // h_kv, *t.shape[2:]).sum(2)  # noqa: E731
    return (dq.astype(q.dtype), fold(dk).astype(k.dtype),
            fold(dv).astype(v.dtype))


def flash_attention_reference(q, k, v, causal: bool = False,
                              sm_scale: Optional[float] = None,
                              kv_lengths: Optional[Array] = None,
                              window: Optional[int] = None) -> Array:
    """Pure-jnp oracle playing the role torch plays in the reference tests
    (tests/test_flash_attention.py:44-77)."""
    _check_heads(q, k, v)
    return _reference_fwd_with_lse(q, k, v, causal, _scale_of(q, sm_scale),
                                   kv_lengths, window)[0]


def mha_attention(q, k, v, causal: bool = False, use_flash: bool = True) -> Array:
    """Multi-head attention entry matching reference MultiHeadAttention
    dispatch (modules_transfomer.py:109-202): flash path or op-graph path."""
    if use_flash:
        return flash_attention(q, k, v, causal)
    return flash_attention_reference(q, k, v, causal)
