"""Multi-chip attention: head/batch-parallel shard_map and ring attention.

Nothing to mirror in the reference (it is single-GPU, SURVEY.md §2.3); this
implements the two standard multi-device shardings for attention:

* :func:`sharded_flash_attention` -- batch over the DP axis, heads over the
  TP axis, zero communication inside attention (the collectives happen in the
  surrounding projections, inserted by GSPMD).  Neither ``pallas_call`` nor
  cuDNN's custom call can be auto-partitioned by GSPMD, so this is the
  shard_map shim that makes the attention routes SPMD.
* :func:`ring_flash_attention` -- sequence (context) parallelism: K/V shards
  rotate around the ``seq`` axis ring via ``jax.lax.ppermute`` while each
  device runs local flash attention, partial results merged with the
  online-softmax lse combine.  The neighbour transfers are NCCL
  point-to-point sends, which XLA can overlap with compute.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_varlen,
    flash_attention_with_lse,
)

Array = jax.Array


def sharded_flash_attention(
    q: Array, k: Array, v: Array, causal: bool = False, *,
    mesh: Mesh,
    batch_axis: Optional[str] = "data",
    head_axis: Optional[str] = "model",
    sm_scale: Optional[float] = None,
    kv_lengths: Optional[Array] = None,
    window: Optional[int] = None,
) -> Array:
    """Flash attention with batch sharded over ``batch_axis`` and heads over
    ``head_axis``; seq and head_dim replicated.  Differentiable.

    Zero communication: every (batch-shard, head-shard) is independent
    (guide §14 "head parallelism first").  ``kv_lengths`` (B,) selects the
    varlen kernel (per-row valid KV prefix) — used by TP-sharded batched
    prefill.  ``window`` = sliding-window attention (static; seq stays
    unsharded here so the window never crosses a shard boundary).
    """
    spec = P(batch_axis, head_axis, None, None)

    if kv_lengths is None:
        @functools.partial(
            jax.shard_map, mesh=mesh, in_specs=(spec, spec, spec),
            out_specs=spec, check_vma=False,
        )
        def _local(q_, k_, v_):
            return flash_attention(q_, k_, v_, causal, sm_scale,
                                   window=window)

        return _local(q, k, v)

    len_spec = P(batch_axis)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(spec, spec, spec, len_spec),
        out_specs=spec, check_vma=False,
    )
    def _local_varlen(q_, k_, v_, lens_):
        return flash_attention_varlen(q_, k_, v_, lens_, causal, sm_scale,
                                      window=window)

    return _local_varlen(q, k, v, kv_lengths)


def sharded_paged_attention(
    q: Array, k_pages: Array, v_pages: Array, lengths: Array,
    page_indices: Array, *,
    mesh: Mesh,
    head_axis: Optional[str] = "model",
    k_scales: Optional[Array] = None,
    v_scales: Optional[Array] = None,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Array:
    """Paged decode with KV-head-sharded page pools (tensor-sharded weights
    and KV).  Each model-axis shard owns a slice of the
    KV heads AND their pages; page tables/lengths replicate.  Zero
    communication inside attention — the collectives live in the projections.
    """
    from ..ops.paged_attention import paged_attention

    # q: (B, Hq, d) single-token or (B, chunk, Hq, d) multi-token decode
    q_spec = (P(None, head_axis, None) if q.ndim == 3
              else P(None, None, head_axis, None))
    pool_spec = P(head_axis, None, None, None)
    rep = P()

    specs = [q_spec, pool_spec, pool_spec, rep, rep]
    args = [q, k_pages, v_pages, lengths, page_indices]
    if k_scales is not None:
        specs += [pool_spec, pool_spec]
        args += [k_scales, v_scales]

        def _local(q_, kp_, vp_, lens_, table_, ks_, vs_):
            return paged_attention(q_, kp_, vp_, lens_, table_,
                                   k_scales=ks_, v_scales=vs_,
                                   sm_scale=sm_scale, window=window)
    else:
        def _local(q_, kp_, vp_, lens_, table_):
            return paged_attention(q_, kp_, vp_, lens_, table_,
                                   window=window,
                                   sm_scale=sm_scale)

    return jax.shard_map(
        _local, mesh=mesh, in_specs=tuple(specs), out_specs=q_spec,
        check_vma=False,
    )(*args)


def _merge_partials(o1, lse1, o2, lse2):
    """Online-softmax merge of two partial attentions (guide §15's
    cross-chip combine, pairwise form).  Empty partials carry lse=-inf."""
    m = jnp.maximum(lse1, lse2)
    # Avoid exp(-inf - -inf) NaN when both sides are empty.
    m_safe = jnp.where(jnp.isinf(m) & (m < 0), 0.0, m)
    w1 = jnp.where(jnp.isinf(lse1) & (lse1 < 0), 0.0, jnp.exp(lse1 - m_safe))
    w2 = jnp.where(jnp.isinf(lse2) & (lse2 < 0), 0.0, jnp.exp(lse2 - m_safe))
    denom = w1 + w2
    denom_safe = jnp.where(denom == 0.0, 1.0, denom)
    o = (w1 * o1 + w2 * o2) / denom_safe
    lse = m_safe + jnp.log(denom_safe)
    lse = jnp.where(denom == 0.0, -jnp.inf, lse)
    return o, lse


def ring_flash_attention(
    q: Array, k: Array, v: Array, causal: bool = False, *,
    mesh: Mesh,
    seq_axis: str = "seq",
    batch_axis: Optional[str] = None,
    head_axis: Optional[str] = None,
    sm_scale: Optional[float] = None,
) -> Array:
    """Context-parallel attention: q/k/v sharded over the sequence dim.

    Each step computes local flash attention against the K/V block currently
    resident, then rotates K/V one hop around the ring (``ppermute``).  With
    ``causal=True``, K/V blocks that originate *after* the local queries are
    skipped entirely via ``lax.cond`` (the SPMD analogue of the reference's
    block-level causal skip, flashattention_kernel.cu:511-515); the
    originating-block-equal step uses the causal kernel; earlier blocks use
    the dense kernel.

    DIFFERENTIABLE: the custom vjp runs the reverse ring — per (q-shard,
    kv-block) pair the blockwise backward (:func:`flash_attention_bwd`
    against the global (o, lse)) produces partial grads;
    dK/dV accumulators travel around the ring WITH their blocks and arrive
    home after a full revolution (the blockwise-parallel transformer /
    ring-attention backward).
    """
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / (d**0.5)
    return _ring_fa(q, k, v, causal, mesh, seq_axis, batch_axis, head_axis,
                    scale)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6, 7, 8))
def _ring_fa(q, k, v, causal, mesh, seq_axis, batch_axis, head_axis, scale):
    o, _ = _ring_fwd(q, k, v, causal, mesh, seq_axis, batch_axis, head_axis,
                     scale)
    return o


def _ring_fwd(q, k, v, causal, mesh, seq_axis, batch_axis, head_axis, scale):
    spec = P(batch_axis, head_axis, seq_axis, None)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=(spec, spec), check_vma=False,
    )
    def _ring(q_, k_, v_):
        n_dev = jax.lax.axis_size(seq_axis)
        me = jax.lax.axis_index(seq_axis)
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

        # Step 0: the local (diagonal) block.
        o, lse = flash_attention_with_lse(q_, k_, v_, causal, scale)

        def step(s, carry):
            o_acc, lse_acc, k_blk, v_blk = carry
            k_blk = jax.lax.ppermute(k_blk, seq_axis, perm)
            v_blk = jax.lax.ppermute(v_blk, seq_axis, perm)
            src = (me - s) % n_dev  # origin shard of the block now resident

            def attend(_):
                return flash_attention_with_lse(q_, k_blk, v_blk, False, scale)

            def skip(_):
                return (jnp.zeros_like(o_acc),
                        jnp.full_like(lse_acc, -jnp.inf))

            if causal:
                # Only blocks from strictly-earlier shards contribute.
                o_p, lse_p = jax.lax.cond(src < me, attend, skip, None)
            else:
                o_p, lse_p = attend(None)
            o_acc, lse_acc = _merge_partials(o_acc, lse_acc, o_p, lse_p)
            return (o_acc, lse_acc, k_blk, v_blk)

        o, lse, _, _ = jax.lax.fori_loop(1, n_dev, step, (o, lse, k_, v_))
        return o.astype(q_.dtype), lse

    return _ring(q, k, v)


def _ring_fa_fwd(q, k, v, causal, mesh, seq_axis, batch_axis, head_axis,
                 scale):
    o, lse = _ring_fwd(q, k, v, causal, mesh, seq_axis, batch_axis, head_axis,
                       scale)
    return o, (q, k, v, o, lse)


def _ring_fa_bwd(causal, mesh, seq_axis, batch_axis, head_axis, scale,
                 res, do):
    q, k, v, o, lse = res
    spec = P(batch_axis, head_axis, seq_axis, None)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, spec),
        out_specs=(spec, spec, spec), check_vma=False,
    )
    def _ring_bwd(q_, k_, v_, o_, lse_, do_):
        n_dev = jax.lax.axis_size(seq_axis)
        me = jax.lax.axis_index(seq_axis)
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

        def pair_bwd(k_blk, v_blk, blk_causal):
            # blockwise FA backward against the GLOBAL (o, lse): the
            # single-device backward on one (q-shard, kv-block) pair,
            # accumulated in f32 around the ring
            grads = flash_attention_bwd(q_, k_blk, v_blk, o_, lse_, do_,
                                        blk_causal, scale)
            return tuple(g.astype(jnp.float32) for g in grads)

        # Diagonal block: local triangle (or dense when not causal).
        dq, dk_acc, dv_acc = pair_bwd(k_, v_, causal)

        def step(s, carry):
            dq, k_blk, v_blk, dk_acc, dv_acc = carry
            # accumulators rotate WITH their block
            k_blk = jax.lax.ppermute(k_blk, seq_axis, perm)
            v_blk = jax.lax.ppermute(v_blk, seq_axis, perm)
            dk_acc = jax.lax.ppermute(dk_acc, seq_axis, perm)
            dv_acc = jax.lax.ppermute(dv_acc, seq_axis, perm)
            src = (me - s) % n_dev

            def contrib(_):
                return pair_bwd(k_blk, v_blk, False)

            def skip(_):
                return (jnp.zeros_like(dq), jnp.zeros_like(dk_acc),
                        jnp.zeros_like(dv_acc))

            if causal:
                dq_p, dk_p, dv_p = jax.lax.cond(src < me, contrib, skip, None)
            else:
                dq_p, dk_p, dv_p = contrib(None)
            return (dq + dq_p, k_blk, v_blk, dk_acc + dk_p, dv_acc + dv_p)

        dq, _, _, dk_acc, dv_acc = jax.lax.fori_loop(
            1, n_dev, step, (dq, k_, v_, dk_acc, dv_acc))
        # one final hop completes the revolution: accumulators return home
        dk_acc = jax.lax.ppermute(dk_acc, seq_axis, perm)
        dv_acc = jax.lax.ppermute(dv_acc, seq_axis, perm)
        return dq.astype(q_.dtype), dk_acc.astype(k_.dtype), dv_acc.astype(v_.dtype)

    return _ring_bwd(q, k, v, o, lse, do)


_ring_fa.defvjp(_ring_fa_fwd, _ring_fa_bwd)
