"""Paged attention: decode over a paged KV-cache.

Serving-path component with no reference equivalent (the reference's
generation re-runs the full model per token, run_machine_translation.py:
300-323).  The KV cache lives in non-contiguous fixed-size pages, each
sequence owns a row of a page table, and attention walks a sequence's pages
with the online-softmax loop.

Two routes, chosen by :func:`choose_paged_impl`:

* ``"triton"`` -- a split-K decode kernel in Pallas, compiled through
  Triton.  One program per (sequence, kv head, block of query rows, split
  of the page table) reads its pages in place (a block of page ids from the table, then those
  pages' K/V), keeps (m, l, acc) for all query heads of the kv head, and
  the splits are merged by their log-sum-exp afterwards.  Decode sits far
  below the card's ridge point, so the point is bytes: history pages are
  read once, at their stored width (int8/fp8 pages are converted in
  registers and their per-token scales applied after the dots).
* ``"reference"`` -- the XLA gather: copy each sequence's pages into a dense
  history, then attend; it writes the history once and reads it back.

Both support GQA, int8/fp8 pages with per-token scales, a sliding
``window`` and multi-token ``chunk`` queries.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ._utils import DEFAULT_MASK_VALUE, cdiv, round_up, use_interpret_mode

Array = jax.Array


def _idiv(a, b):
    """Integer division of traced int32 scalars (lax.div wants one dtype;
    python ints and x64 mode would otherwise mix int32 and int64)."""
    return lax.div(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))

LOG2E = 1.4426950408889634

PAGED_IMPLS = ("auto", "reference", "triton")

# Keys per loop step of the kernel: pages_per_block * page_size.
_BLOCK_K = 128
# Query rows (group * chunk) per program: decode fits one block; a
# prefill-extend chunk spreads over several.
_BLOCK_ROWS = 64
# Programs to aim for (about four per SM of the card's 132): splitting the
# page table that finely measured 18% faster at B16 and even at B4 than two
# per SM (PERF.md).
_TARGET_PROGRAMS = 528


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def choose_paged_impl(q_head_dim: int, page_size: int, impl: str = "auto",
                      platform: Optional[str] = None) -> str:
    """The route of one paged call.  ``impl`` other than "auto" is honoured
    as given.  "auto" takes the Triton kernel wherever its shapes allow --
    on the GPU a power-of-two head dim >= 16 and page size, which the H100
    measurements in PERF.md favour at every decode shape measured; on the
    CPU, where the kernel runs through the Pallas interpreter, every shape
    -- and the XLA gather otherwise.  The CPU default keeps the engine's
    decode numerics independent of the chunk width (rows are padded to one
    tile), which its equivalence tests rely on."""
    if impl not in PAGED_IMPLS:
        raise ValueError(f"impl must be one of {PAGED_IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return "triton"
    if (platform == "gpu" and _is_pow2(q_head_dim) and q_head_dim >= 16
            and _is_pow2(page_size)):
        return "triton"
    return "reference"


def _paged_kernel(q_ref, k_ref, v_ref, ks_ref, vs_ref, table_ref, len_ref,
                  o_ref, m_ref, l_ref, *, page_size, pages_per_block,
                  cols_per_split, pages_per_seq, chunk, window):
    row_block, split = pl.program_id(2), pl.program_id(3)
    length = len_ref[0]
    base = length - chunk            # tokens before the chunk
    q = q_ref[...]                   # (rows, d), prescaled by scale*log2(e)
    n_rows = q.shape[0]
    bk = pages_per_block * page_size
    rows = row_block * n_rows + jnp.arange(n_rows)
    # rows are ordered (group, chunk): row r is chunk token r % chunk, at
    # position base + r % chunk, attending positions < bound
    bound = base + rows - _idiv(rows, chunk) * chunk + 1

    n_cols = jnp.minimum(_idiv(jnp.max(bound) + page_size - 1, page_size),
                         pages_per_seq)
    c0 = split * cols_per_split
    start = c0
    if window is not None:
        first = _idiv(jnp.maximum(jnp.min(bound) - window, 0), page_size)
        skip = jnp.maximum(first - c0, 0)
        start = c0 + _idiv(skip, pages_per_block) * pages_per_block
    stop = jnp.minimum(c0 + cols_per_split, n_cols)
    n_blocks = jnp.maximum(_idiv(stop - start + pages_per_block - 1,
                                   pages_per_block), 0)

    def body(t, carry):
        acc, m, l = carry
        col = start + t * pages_per_block
        ids = table_ref[pl.ds(col, pages_per_block)]
        k = k_ref[ids].reshape(bk, -1).astype(q.dtype)
        v = v_ref[ids].reshape(bk, -1).astype(q.dtype)
        s = pl.dot(q, k.T)
        if ks_ref is not None:
            s = s * ks_ref[ids].reshape(1, bk)
        pos = col * page_size + jnp.arange(bk)
        keep = pos[None, :] < bound[:, None]
        if window is not None:
            keep &= pos[None, :] >= bound[:, None] - window
        s = jnp.where(keep, s, DEFAULT_MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.where(keep, jnp.exp2(s - m_new[:, None]), 0.0)
        l = alpha * l + jnp.sum(p, axis=1)
        if vs_ref is not None:
            p = p * vs_ref[ids].reshape(1, bk)
        acc = acc * alpha[:, None] + pl.dot(p.astype(v.dtype), v)
        return acc, m_new, l

    acc = jnp.zeros(q.shape, jnp.float32)
    m = jnp.full((n_rows,), DEFAULT_MASK_VALUE, jnp.float32)
    l = jnp.zeros((n_rows,), jnp.float32)
    acc, m, l = lax.fori_loop(0, n_blocks, body, (acc, m, l))
    o_ref[...] = acc
    m_ref[...] = m
    l_ref[...] = l


def _paged_triton(qg, k_pages, v_pages, lengths, page_indices, k_scales,
                  v_scales, chunk, window):
    """qg: (B, Hkv, rows, d) prescaled.  Returns (B, Hkv, rows, d) f32."""
    b, h_kv, n_rows, d = qg.shape
    _, n_pages, page_size, _ = k_pages.shape
    pages_per_seq = page_indices.shape[1]
    ppb = max(1, _BLOCK_K // page_size)
    rows_p = max(16, pl.next_power_of_2(n_rows))
    block_r = min(rows_p, _BLOCK_ROWS)
    n_rb = rows_p // block_r
    splits = min(pl.next_power_of_2(cdiv(_TARGET_PROGRAMS, b * h_kv * n_rb)),
                 cdiv(pages_per_seq, ppb))
    cols_per_split = round_up(cdiv(pages_per_seq, splits), ppb)
    cols_pad = splits * cols_per_split
    table = jnp.pad(page_indices.astype(jnp.int32),
                    ((0, 0), (0, cols_pad - pages_per_seq)))
    if rows_p != n_rows:
        qg = jnp.pad(qg, ((0, 0), (0, 0), (0, rows_p - n_rows), (0, 0)))
    quantized = k_scales is not None

    pool = pl.BlockSpec((None, n_pages, page_size, d),
                        lambda b_, h_, r_, s_: (h_, 0, 0, 0))
    scale_spec = pl.BlockSpec((None, n_pages, page_size),
                              lambda b_, h_, r_, s_: (h_, 0, 0))
    in_specs = [pl.BlockSpec((None, None, block_r, d),
                             lambda b_, h_, r_, s_: (b_, h_, r_, 0)),
                pool, pool,
                scale_spec if quantized else None,
                scale_spec if quantized else None,
                pl.BlockSpec((None, cols_pad), lambda b_, h_, r_, s_: (b_, 0)),
                pl.BlockSpec((1,), lambda b_, h_, r_, s_: (b_,))]
    if quantized:
        k_scales = k_scales.reshape(h_kv, n_pages, page_size)
        v_scales = v_scales.reshape(h_kv, n_pages, page_size)
    split_vec = pl.BlockSpec((None, None, None, block_r),
                             lambda b_, h_, r_, s_: (b_, h_, s_, r_))
    kernel = functools.partial(
        _paged_kernel, page_size=page_size, pages_per_block=ppb,
        cols_per_split=cols_per_split, pages_per_seq=pages_per_seq,
        chunk=chunk, window=window)
    o, m, l = pl.pallas_call(
        kernel,
        grid=(b, h_kv, n_rb, splits),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((None, None, None, block_r, d),
                                lambda b_, h_, r_, s_: (b_, h_, s_, r_, 0)),
                   split_vec, split_vec],
        out_shape=[jax.ShapeDtypeStruct((b, h_kv, splits, rows_p, d),
                                        jnp.float32),
                   jax.ShapeDtypeStruct((b, h_kv, splits, rows_p), jnp.float32),
                   jax.ShapeDtypeStruct((b, h_kv, splits, rows_p), jnp.float32)],
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=use_interpret_mode(),
        name="paged_decode",
    )(qg, k_pages, v_pages, k_scales, v_scales, table,
      lengths.astype(jnp.int32))
    # merge the splits by their (base-2) log-sum-exp
    m_all = jnp.max(m, axis=2, keepdims=True)
    w = jnp.exp2(m - m_all)
    l_all = jnp.sum(w * l, axis=2)
    o = jnp.sum(w[..., None] * o, axis=2)
    o = o / jnp.where(l_all == 0.0, 1.0, l_all)[..., None]
    return o[:, :, :n_rows]


def paged_attention(
    q: Array,                      # (B, n_q_heads, d) or (B, chunk, n_q_heads, d)
    k_pages: Array,                # (n_kv_heads, n_pages, page_size, d)
    v_pages: Array,
    lengths: Array,                # (B,) int32 valid tokens per sequence
    page_indices: Array,           # (B, pages_per_seq) int32 page table
    *,
    k_scales: Optional[Array] = None,   # (n_kv_heads, n_pages, page_size, 1)
    v_scales: Optional[Array] = None,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    impl: str = "auto",
) -> Array:
    """Decode-time attention of one query token (or a ``chunk`` of tokens)
    per sequence against its paged KV history.  Returns (B, n_q_heads, d)
    (or (B, chunk, n_q_heads, d) for a 4-d q).

    A chunked q enables multi-token decode -- speculative-decoding
    verification and chunked prefill-extend: chunk row j sits at absolute
    position ``lengths - chunk + j`` and attends causally within the chunk;
    ``lengths`` counts valid tokens INCLUDING the chunk, whose K/V must
    already be scattered into the pages.  ``window`` restricts attention to
    the last ``window`` positions; the kernel starts its walk at the first
    in-window page, so page loads are O(window)."""
    d = q.shape[-1]
    page_size = k_pages.shape[2]
    if choose_paged_impl(d, page_size, impl) == "reference":
        return paged_attention_reference(q, k_pages, v_pages, lengths,
                                         page_indices, k_scales, v_scales,
                                         sm_scale, window)
    chunked_in = q.ndim == 4
    if not chunked_in:
        q = q[:, None]                          # (B, 1, Hq, d)
    b, chunk, n_q_heads, _ = q.shape
    n_kv_heads = k_pages.shape[0]
    assert n_q_heads % n_kv_heads == 0
    group = n_q_heads // n_kv_heads
    scale = sm_scale if sm_scale is not None else 1.0 / (d**0.5)

    # (B, chunk, Hq, d) -> (B, Hkv, group*chunk, d) with rows ordered
    # (group, chunk); prescaled with log2(e) folded in (base-2 softmax)
    qg = q * jnp.asarray(scale * LOG2E, q.dtype)
    qg = qg.reshape(b, chunk, n_kv_heads, group, d)
    qg = qg.transpose(0, 2, 3, 1, 4).reshape(b, n_kv_heads, group * chunk, d)
    out = _paged_triton(qg, k_pages, v_pages, lengths, page_indices,
                        k_scales, v_scales, chunk, window)
    out = out.reshape(b, n_kv_heads, group, chunk, d)
    out = out.transpose(0, 3, 1, 2, 4).reshape(b, chunk, n_q_heads, d)
    out = out.astype(q.dtype)
    return out if chunked_in else out[:, 0]


def paged_attention_reference(q, k_pages, v_pages, lengths, page_indices,
                              k_scales=None, v_scales=None, sm_scale=None,
                              window=None):
    """jnp oracle and XLA route: gather pages densely, mask by length, full
    softmax.  ``q`` may be (B, Hq, d) or chunked (B, chunk, Hq, d) -- chunk
    row j sits at position ``lengths - chunk + j`` (same convention as the
    kernel).  Pages are gathered at their stored width and dequantised
    after the gather."""
    chunked_in = q.ndim == 4
    if not chunked_in:
        q = q[:, None]
    b, chunk, n_q_heads, d = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    scale = sm_scale if sm_scale is not None else 1.0 / (d**0.5)

    def gather(pages, scales):
        # (Hkv, B, pages, page, d) -> (B, Hkv, pages*page, d)
        t = pages[:, page_indices].astype(jnp.float32)
        if scales is not None:
            t = t * scales[:, page_indices]
        return t.transpose(1, 0, 2, 3, 4).reshape(b, n_kv_heads, -1, d)

    k_seq = gather(k_pages, k_scales)
    v_seq = gather(v_pages, v_scales)
    qg = q.reshape(b, chunk, n_kv_heads, group, d).astype(jnp.float32)
    s = jnp.einsum("bjhgd,bhkd->bjhgk", qg, k_seq) * scale
    pos = jnp.arange(s.shape[-1])[None, None, None, None, :]  # (1,1,1,1,K)
    bound = (lengths[:, None] - chunk + 1
             + jnp.arange(chunk)[None, :])          # (B, chunk) exclusive
    bound = bound[:, :, None, None, None]
    keep = pos < bound
    if window is not None:
        keep &= pos >= bound - window
    s = jnp.where(keep, s, -1e30)
    w = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bjhgk,bhkd->bjhgd", w, v_seq)
    o = o.reshape(b, chunk, n_q_heads, d).astype(q.dtype)
    return o if chunked_in else o[:, 0]
