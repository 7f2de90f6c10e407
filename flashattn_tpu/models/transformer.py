"""Decoder-only transformer model family.

JAX equivalents of reference ``minitorch/modules_transfomer.py``:
``MultiHeadAttention:19-230``, ``FeedForward:233-276``,
``TransformerLayer:279-362``, ``DecoderLM:365-470``.

Differences by design (documented against SURVEY.md §2 defect list):

* One model definition, its attention paths selected by ``attn_impl``:
  ``"flash"`` (the flash-attention routes of ``ops/flash_attention.py``,
  chosen per call by ``choose_impl``), ``"cudnn"`` or ``"triton"`` (one of
  those routes, pinned), ``"fused_softmax"`` (op-graph matmuls + the masked
  softmax op -- the reference's ``use_fused_kernel`` path), and
  ``"reference"`` (pure jnp op-graph, for paged decode too).  The
  reference's mis-wired positional flag plumbing
  (modules_transfomer.py:309-311,409-420) is replaced by this single kwarg.
* ``n_layer`` is a constructor argument (the reference hard-codes 4 layers).
* Dropout consumes explicit PRNG keys; eval mode and ``key=None`` are
  deterministic.
* The causal mask is generated in-kernel from iota, never materialised as a
  (B,H,T,T) tensor in device memory (reference modules_transfomer.py:63-71).
"""

from __future__ import annotations

import math
from typing import Literal, Optional

import jax
import jax.numpy as jnp

from ..module import Module
from ..nn import functional as F
from ..nn.basic import Dropout, Embedding, LayerNorm1d, Linear
from ..ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_attention_varlen,
    repeat_kv,
)
from ..ops.paged_attention import paged_attention
from ..ops.softmax import attn_softmax

Array = jax.Array

AttnImpl = Literal["flash", "cudnn", "triton", "fused_softmax", "reference"]


def _quantize_kv(t, dtype):
    """Per-token symmetric quantisation for paged-pool writes: payload in
    ``dtype`` (int8 absmax/127 or fp8-e4m3 absmax/448) + f32 scales."""
    qmax = 127.0 if dtype == jnp.int8 else 448.0
    absmax = jnp.max(jnp.abs(t.astype(jnp.float32)), -1, keepdims=True)
    scale = jnp.where(absmax == 0, 1.0, absmax / qmax)
    payload = t.astype(jnp.float32) / scale
    if dtype == jnp.int8:
        payload = jnp.clip(jnp.round(payload), -127, 127)
    return payload.astype(dtype), scale


def _split(key: Optional[jax.Array], n: int):
    if key is None:
        return [None] * n
    return list(jax.random.split(key, n))


def remat_policy(name: Optional[str]):
    """Map a policy name onto a ``jax.checkpoint`` saveable-filter.

    ``"nothing"`` rematerialises every layer intermediate in the backward
    pass (max memory saving, ~1.33x forward flops); ``"dots"`` saves matmul
    outputs that have no batch dim (weight-stationary products) and
    recomputes the rest.
    """
    if name in (None, "nothing", "none"):
        return None  # jax.checkpoint default: save only the layer inputs
    if name == "dots":
        return jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    raise ValueError(f"unknown remat policy {name!r} (want nothing|dots)")


class MultiHeadAttention(Module):
    """Multi-head (optionally causal) self-attention.

    Mirrors reference ``MultiHeadAttention`` (modules_transfomer.py:19-230):
    four Linear projections, scores scaled by 1/sqrt(attn_hidden_dim),
    head split/merge via reshape+transpose.
    """

    def __init__(self, n_embd: int, n_head: int, causal: bool = False,
                 p_dropout: float = 0.1, bias: bool = True, *,
                 n_kv_head: Optional[int] = None,
                 attn_impl: AttnImpl = "flash",
                 pos_encoding: str = "none", rope_theta: float = 10000.0,
                 window: Optional[int] = None,
                 key: jax.Array, dtype=jnp.float32):
        assert n_embd % n_head == 0
        # sliding-window (local causal) attention; None = full attention
        assert window is None or causal, "window requires causal attention"
        self.window = window
        assert pos_encoding in ("none", "rope"), (
            f"pos_encoding must be 'none' or 'rope', got {pos_encoding!r} "
            f"(anything else would silently disable position information)")
        self.n_embd = n_embd
        self.n_head = n_head
        # GQA/MQA: fewer KV heads shared across query-head groups
        self.n_kv_head = n_kv_head or n_head
        assert n_head % self.n_kv_head == 0
        self.causal = causal
        self.attn_hidden_dim = n_embd // n_head
        self.attn_impl = attn_impl
        # "rope" rotates q/k per-position after projection (ops/rope.py);
        # the KV caches/pools then hold post-rotation keys, so every decode
        # path is position-lookup-free.  "none" = positions handled by the
        # model (learned absolute embeddings, the reference's scheme).
        self.pos_encoding = pos_encoding
        self.rope_theta = rope_theta
        # Multi-device wiring (static): set via parallel.sharding.apply_mesh.
        # GSPMD cannot partition pallas_call or cuDNN's custom call, so the
        # flash path switches to the shard_map shim when a mesh is
        # attached.  mesh_seq_axis selects sequence/context parallelism:
        # activations sharded over the sequence dim, attention via the
        # differentiable ring (ppermute).
        self.mesh = None
        self.mesh_batch_axis = None
        self.mesh_head_axis = None
        self.mesh_seq_axis = None
        kq, kk, kv, ko = jax.random.split(key, 4)
        kv_dim = self.n_kv_head * self.attn_hidden_dim
        self.q_projection = Linear(n_embd, n_embd, bias, key=kq, dtype=dtype)
        self.k_projection = Linear(n_embd, kv_dim, bias, key=kk, dtype=dtype)
        self.v_projection = Linear(n_embd, kv_dim, bias, key=kv, dtype=dtype)
        self.out_projection = Linear(n_embd, n_embd, bias, key=ko, dtype=dtype)
        self.dropout = Dropout(p_dropout)

    @property
    def _flash_route(self) -> str:
        """The ``impl`` of the flash-attention calls: "flash" (and the
        engine's prefill under "fused_softmax") lets ``choose_impl`` pick."""
        return ("auto" if self.attn_impl in ("flash", "fused_softmax")
                else self.attn_impl)

    @property
    def _paged_route(self) -> str:
        """The ``impl`` of the paged-decode calls: the Triton kernel or the
        XLA gather when pinned, else ``choose_paged_impl``'s pick."""
        return (self.attn_impl if self.attn_impl in ("triton", "reference")
                else "auto")

    def project_to_query_key_value(self, x: Array, kv_src: Optional[Array] = None):
        """(B,S,E) -> q (B,nh,S,hd), k/v (B,n_kv_head,Skv,hd)
        (reference :73-107; GQA when n_kv_head < n_head).  ``kv_src`` routes
        K/V through a different sequence (cross-attention over encoder
        memory); default is self-attention (kv_src = x)."""
        kv_src = x if kv_src is None else kv_src

        def proj(lin: Linear, src: Array, heads: int) -> Array:
            bs, seq, _ = src.shape
            y = lin(src)
            y = y.reshape(bs, seq, heads, self.attn_hidden_dim)
            return y.transpose(0, 2, 1, 3)

        return (proj(self.q_projection, x, self.n_head),
                proj(self.k_projection, kv_src, self.n_kv_head),
                proj(self.v_projection, kv_src, self.n_kv_head))

    def _rope(self, q: Array, k: Array, positions: Array):
        """Rotate q and the NEW k tokens at ``positions`` (cached keys are
        already rotated).  No-op unless pos_encoding == "rope"."""
        if self.pos_encoding != "rope":
            return q, k
        from ..ops.rope import apply_rope

        return (apply_rope(q, positions, self.rope_theta),
                apply_rope(k, positions, self.rope_theta))

    def self_attention(self, q: Array, k: Array, v: Array,
                       kv_lengths: Optional[Array] = None) -> Array:
        """softmax(q k^T / sqrt(hd)) v -> (B,Sq,E) (reference :109-202).

        ``kv_lengths`` (B,) masks keys/values past each row's valid prefix
        (padded encoder memory / ragged batches) — fused in-kernel on the
        flash path, an additive mask on the fused-softmax path (the
        reference's padding-mask add, softmax_kernel.cu:232-292).
        """
        bs, nh, seq, hd = q.shape
        if self.attn_impl in ("flash", "cudnn", "triton"):
            if (self.mesh is not None and self.mesh_seq_axis is not None
                    and self.mesh_seq_axis in self.mesh.axis_names):
                # SP/context parallelism: the differentiable ring.  Axes the
                # mesh doesn't carry are normalised away so a pure seq mesh
                # (or seq x model) works with the default axis names.
                from ..parallel.sharded_attention import ring_flash_attention

                # real raises, not asserts: under python -O a stripped guard
                # would silently compute full attention instead of failing
                if kv_lengths is not None:
                    raise ValueError(
                        "ring attention path does not support varlen masks")
                if self.window is not None:
                    raise ValueError(
                        "ring attention path does not support sliding windows")
                names = self.mesh.axis_names
                out = ring_flash_attention(
                    q, k, v, self.causal, mesh=self.mesh,
                    seq_axis=self.mesh_seq_axis,
                    batch_axis=(self.mesh_batch_axis
                                if self.mesh_batch_axis in names else None),
                    head_axis=(self.mesh_head_axis
                               if self.mesh_head_axis in names else None),
                )
            elif self.mesh is not None:
                from ..parallel.sharded_attention import sharded_flash_attention

                out = sharded_flash_attention(
                    q, k, v, self.causal, mesh=self.mesh,
                    batch_axis=self.mesh_batch_axis,
                    head_axis=self.mesh_head_axis,
                    kv_lengths=kv_lengths, window=self.window,
                )
            elif kv_lengths is not None:
                out = flash_attention_varlen(q, k, v, kv_lengths, self.causal,
                                             impl=self._flash_route,
                                             window=self.window)
            else:
                out = flash_attention(q, k, v, self.causal,
                                      impl=self._flash_route,
                                      window=self.window)
        elif self.attn_impl == "fused_softmax":
            k, v = repeat_kv(k, v, q.shape[1])
            s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
            mask = None
            n_kv = k.shape[2]
            if kv_lengths is not None:
                valid = jnp.arange(n_kv)[None, :] < kv_lengths[:, None]
                mask = jnp.where(valid, 0.0, -1e9)[:, None, None, :]
            if self.window is not None:
                # absolute row positions equal col positions here (self-attn)
                local = (jnp.arange(n_kv)[None, :]
                         > jnp.arange(seq)[:, None] - self.window)
                wmask = jnp.where(local, 0.0, -1e9)[None, None, :, :]
                mask = wmask if mask is None else mask + wmask
            w = attn_softmax(s, mask, self.causal)
            out = jnp.einsum("bhqk,bhkd->bhqd", w, v)
        else:
            out = flash_attention_reference(q, k, v, self.causal,
                                            kv_lengths=kv_lengths,
                                            window=self.window)
        return out.transpose(0, 2, 1, 3).reshape(bs, seq, self.n_embd)

    def forward(self, x: Array, key: Optional[jax.Array] = None,
                kv: Optional[Array] = None,
                kv_lengths: Optional[Array] = None) -> Array:
        """Self-attention over ``x``; cross-attention when ``kv`` (the
        encoder memory) is given, optionally masked past ``kv_lengths``.
        RoPE applies to self-attention only (cross q/k live on different
        position scales)."""
        q, k, v = self.project_to_query_key_value(x, kv)
        if kv is None:
            q, k = self._rope(q, k, jnp.arange(x.shape[1], dtype=jnp.int32))
        attn = self.self_attention(q, k, v, kv_lengths)
        return self.out_projection(attn)

    # -- KV-cached decode path ---------------------------------------------
    # The reference's generate() re-runs the whole model per new token
    # (run_machine_translation.py:300-323, "no KV cache" -- O(len^2) model
    # invocations).  Here a static-shape cache is updated with
    # dynamic_update_slice so the decode step jits once.

    def init_cache(self, batch: int, max_len: int, dtype=jnp.float32) -> dict:
        shape = (batch, self.n_kv_head, max_len, self.attn_hidden_dim)
        return {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}

    def forward_decode(self, x: Array, cache: dict, index: Array):
        """One decode step.  x: (B, 1, E); index: scalar position.

        Returns (out (B, 1, E), updated cache).
        """
        bs = x.shape[0]
        q, k, v = self.project_to_query_key_value(x)  # (B, nh, 1, hd)
        q, k = self._rope(q, k, jnp.asarray(index, jnp.int32))
        cache_k = jax.lax.dynamic_update_slice(cache["k"], k.astype(cache["k"].dtype),
                                               (0, 0, index, 0))
        cache_v = jax.lax.dynamic_update_slice(cache["v"], v.astype(cache["v"].dtype),
                                               (0, 0, index, 0))
        max_len = cache_k.shape[2]
        ck, cv = repeat_kv(cache_k, cache_v, q.shape[1])
        s = jnp.einsum("bhqd,bhkd->bhqk", q, ck) / math.sqrt(self.attn_hidden_dim)
        pos = jnp.arange(max_len)[None, None, None, :]
        valid = pos <= index
        if self.window is not None:
            valid &= pos > index - self.window
        s = jnp.where(valid, s, jnp.finfo(s.dtype).min / 2)
        w = jax.nn.softmax(s, axis=-1)
        out = jnp.einsum("bhqk,bhkd->bhqd", w, cv)
        out = out.transpose(0, 2, 1, 3).reshape(bs, 1, self.n_embd)
        return self.out_projection(out), {"k": cache_k, "v": cache_v}

    # -- paged decode (serving path: non-contiguous per-sequence KV pages) --

    def init_page_pool(self, total_pages: int, page_size: int,
                       dtype=jnp.float32) -> dict:
        """Per-layer paged KV pool.  ``dtype`` of int8 / float8_e4m3fn builds
        a QUANTIZED pool: payloads + per-token f32 scales."""
        shape = (self.n_kv_head, total_pages, page_size, self.attn_hidden_dim)
        pool = {"k": jnp.zeros(shape, dtype), "v": jnp.zeros(shape, dtype)}
        if dtype in (jnp.int8, jnp.float8_e4m3fn):
            sshape = shape[:-1] + (1,)
            pool["ks"] = jnp.ones(sshape, jnp.float32)
            pool["vs"] = jnp.ones(sshape, jnp.float32)
        return pool

    def forward_prefill_paged(self, x: Array, pool: dict, page_table: Array,
                              prompt_lens: Array):
        """Batched PREFILL into a paged KV pool: process whole (padded)
        prompts in one step.  x: (B, S, E); prompt_lens: (B,) valid tokens
        per row (0 = idle row, routed to the trash page by the caller's
        table).  Writes all S positions' K/V into the pages and returns
        (out (B, S, E), pool) — attention is causal + varlen-masked, so
        padding rows/positions never contaminate live ones.
        """
        bs, seq, _ = x.shape
        page_size = pool["k"].shape[2]
        quantized = "ks" in pool
        q, k, v = self.project_to_query_key_value(x)   # (B, nh, S, hd)
        q, k = self._rope(q, k, jnp.arange(seq, dtype=jnp.int32))

        # scatter all S tokens' K/V: position p of row b lands in page
        # table[b, p // page] at offset p % page
        pos = jnp.arange(seq, dtype=jnp.int32)
        cols = pos // page_size                        # (S,)
        page_ids = page_table[:, :][:, cols]           # (B, S)
        offs = jnp.broadcast_to(pos % page_size, (bs, seq))
        flat_pages = page_ids.reshape(-1)
        flat_offs = offs.reshape(-1)
        # (nh, B*S, hd)
        k_new = k.transpose(1, 0, 2, 3).reshape(k.shape[1], -1, k.shape[3])
        v_new = v.transpose(1, 0, 2, 3).reshape(v.shape[1], -1, v.shape[3])
        if quantized:
            k_pay, k_sc = _quantize_kv(k_new, pool["k"].dtype)
            v_pay, v_sc = _quantize_kv(v_new, pool["v"].dtype)
            pool = {
                "k": pool["k"].at[:, flat_pages, flat_offs].set(k_pay),
                "v": pool["v"].at[:, flat_pages, flat_offs].set(v_pay),
                "ks": pool["ks"].at[:, flat_pages, flat_offs].set(k_sc),
                "vs": pool["vs"].at[:, flat_pages, flat_offs].set(v_sc),
            }
        else:
            pool = {
                "k": pool["k"].at[:, flat_pages, flat_offs].set(
                    k_new.astype(pool["k"].dtype)),
                "v": pool["v"].at[:, flat_pages, flat_offs].set(
                    v_new.astype(pool["v"].dtype)),
            }

        # prefill attention: causal within the prompt, per-row valid prefix
        # (the cache holds nothing older, so attending q/k/v directly is
        # exact); fp-precision q/k/v regardless of pool quantisation.
        # Under a mesh the kernels must run through shard_map (GSPMD cannot
        # partition them).
        if self.mesh is not None:
            from ..parallel.sharded_attention import sharded_flash_attention

            out = sharded_flash_attention(
                q, k, v, True, mesh=self.mesh,
                batch_axis=self.mesh_batch_axis,
                head_axis=self.mesh_head_axis,
                sm_scale=1.0 / math.sqrt(self.attn_hidden_dim),
                kv_lengths=prompt_lens, window=self.window)
        else:
            out = flash_attention_varlen(
                q, k, v, prompt_lens, True,
                1.0 / math.sqrt(self.attn_hidden_dim),
                impl=self._flash_route, window=self.window)
        out = out.transpose(0, 2, 1, 3).reshape(bs, seq, self.n_embd)
        return self.out_projection(out), pool

    def forward_extend_paged(self, x: Array, pool: dict, page_table: Array,
                             lengths: Array):
        """Multi-token decode against a paged KV pool: x (B, k, E) extends
        each sequence by k tokens at positions ``lengths + j`` in ONE pass
        (causal within the chunk) — the primitive behind speculative-decode
        verification and chunked prefill-extend.  ``lengths`` is the BASE
        (tokens already cached).  Returns (out (B, k, E), updated pool)."""
        bs, kk, _ = x.shape
        page_size = pool["k"].shape[2]
        quantized = "ks" in pool
        q, k, v = self.project_to_query_key_value(x)   # (B, nh, k, hd)
        positions = lengths.astype(jnp.int32)[:, None] + jnp.arange(
            kk, dtype=jnp.int32)[None]                 # (B, k)
        q, k = self._rope(q, k, positions)

        # scatter the chunk's K/V at per-row offsets (pages already owned).
        # Positions are clamped to the table's capacity for the WRITE only:
        # chunked prefill pads its final wave past short rows' prompts, and
        # an out-of-range table column would otherwise be clamped by
        # take_along_axis onto the row's LAST REAL page.  Clamped writes
        # collapse onto position capacity-1, whose offset is overwritten
        # before any read (attention is bounded by the true lengths).
        cap = page_table.shape[1] * page_size
        write_pos = jnp.minimum(positions, cap - 1)
        cols = write_pos // page_size                  # (B, k) table columns
        page_ids = jnp.take_along_axis(page_table, cols, axis=1)
        offs = write_pos % page_size
        flat_pages = page_ids.reshape(-1)
        flat_offs = offs.reshape(-1)
        k_new = k.transpose(1, 0, 2, 3).reshape(k.shape[1], -1, k.shape[3])
        v_new = v.transpose(1, 0, 2, 3).reshape(v.shape[1], -1, v.shape[3])
        if quantized:
            k_pay, k_sc = _quantize_kv(k_new, pool["k"].dtype)
            v_pay, v_sc = _quantize_kv(v_new, pool["v"].dtype)
            pool = {
                "k": pool["k"].at[:, flat_pages, flat_offs].set(k_pay),
                "v": pool["v"].at[:, flat_pages, flat_offs].set(v_pay),
                "ks": pool["ks"].at[:, flat_pages, flat_offs].set(k_sc),
                "vs": pool["vs"].at[:, flat_pages, flat_offs].set(v_sc),
            }
        else:
            pool = {
                "k": pool["k"].at[:, flat_pages, flat_offs].set(
                    k_new.astype(pool["k"].dtype)),
                "v": pool["v"].at[:, flat_pages, flat_offs].set(
                    v_new.astype(pool["v"].dtype)),
            }

        qc = q.transpose(0, 2, 1, 3)                   # (B, k, nh, hd)
        kwargs = dict(sm_scale=1.0 / math.sqrt(self.attn_hidden_dim),
                      window=self.window)
        if quantized:
            kwargs.update(k_scales=pool["ks"], v_scales=pool["vs"])
        if self.mesh is not None:
            from ..parallel.sharded_attention import sharded_paged_attention

            out = sharded_paged_attention(
                qc, pool["k"], pool["v"], lengths + kk, page_table,
                mesh=self.mesh, head_axis=self.mesh_head_axis, **kwargs)
        else:
            out = paged_attention(qc, pool["k"], pool["v"], lengths + kk,
                                  page_table, impl=self._paged_route,
                                  **kwargs)   # (B, k, nh, hd)
        out = out.reshape(bs, kk, self.n_embd)
        return self.out_projection(out), pool

    def forward_decode_paged(self, x: Array, pool: dict, page_table: Array,
                             lengths: Array):
        """One decode step against a paged KV pool: the k=1 special case of
        :meth:`forward_extend_paged` (one body — scatter/quantize/rope/
        attention dispatch cannot diverge between the paths).

        x: (B, 1, E); page_table: (B, pages_per_seq) int32 physical page ids;
        lengths: (B,) tokens already in each sequence's cache (the new token
        lands at position ``lengths``).  Returns (out (B,1,E), updated pool).
        """
        return self.forward_extend_paged(x, pool, page_table, lengths)


class FeedForward(Module):
    """GELU MLP n_embd -> middle_dim -> n_embd (reference :233-276)."""

    def __init__(self, n_embd: int, middle_dim: int = 256, p_dropout: float = 0.1,
                 bias: bool = True, *, key: jax.Array, dtype=jnp.float32):
        k1, k2 = jax.random.split(key)
        self.linear_in = Linear(n_embd, middle_dim, bias, key=k1, dtype=dtype)
        self.linear_out = Linear(middle_dim, n_embd, bias, key=k2, dtype=dtype)
        self.dropout = Dropout(p_dropout)

    def forward(self, x: Array, key: Optional[jax.Array] = None) -> Array:
        x = F.GELU(self.linear_in(x))
        return self.dropout(self.linear_out(x), key=key)


class TransformerLayer(Module):
    """Pre-LN transformer layer (reference :279-362).

    ln_1 -> causal MHA -> residual -> ln_2 -> FFN -> residual.
    """

    def __init__(self, n_embd: int, n_head: int, p_dropout: float = 0.1,
                 ln_eps: float = 1e-5, bias: bool = True, *,
                 middle_dim: int = 256,
                 n_kv_head: Optional[int] = None,
                 attn_impl: AttnImpl = "flash",
                 pos_encoding: str = "none", rope_theta: float = 10000.0,
                 window: Optional[int] = None,
                 n_experts: Optional[int] = None, moe_top_k: int = 2,
                 key: jax.Array, dtype=jnp.float32):
        ka, kf = jax.random.split(key)
        self.attention = MultiHeadAttention(
            n_embd, n_head, causal=True, p_dropout=p_dropout, bias=bias,
            n_kv_head=n_kv_head, attn_impl=attn_impl,
            pos_encoding=pos_encoding, rope_theta=rope_theta, window=window,
            key=ka, dtype=dtype,
        )
        if n_experts:
            from .moe import MoEFeedForward

            self.ff = MoEFeedForward(n_embd, middle_dim, n_experts,
                                     top_k=moe_top_k, p_dropout=p_dropout,
                                     key=kf, dtype=dtype)
        else:
            self.ff = FeedForward(n_embd, middle_dim, p_dropout, bias,
                                  key=kf, dtype=dtype)
        self.ln_1 = LayerNorm1d(n_embd, ln_eps, dtype=dtype)
        self.ln_2 = LayerNorm1d(n_embd, ln_eps, dtype=dtype)

    def forward(self, x: Array, key: Optional[jax.Array] = None) -> Array:
        return self.forward_with_aux(x, key=key)[0]

    def forward_with_aux(self, x: Array, key: Optional[jax.Array] = None):
        """(x, aux): MoE layers surface the load-balancing loss; dense
        layers report 0.  ``forward`` is this with the aux dropped — one
        body so train/inference paths cannot diverge."""
        k1, k2 = _split(key, 2)
        x = x + self.attention(self.ln_1(x), key=k1)
        if hasattr(self.ff, "forward_with_aux"):
            y, aux = self.ff.forward_with_aux(self.ln_2(x), key=k2)
        else:
            y, aux = self.ff(self.ln_2(x), key=k2), jnp.float32(0.0)
        return x + y, aux

    def forward_decode(self, x: Array, cache: dict, index: Array):
        attn, cache = self.attention.forward_decode(self.ln_1(x), cache, index)
        x = x + attn
        x = x + self.ff(self.ln_2(x))
        return x, cache

    def forward_decode_paged(self, x: Array, pool: dict, page_table: Array,
                             lengths: Array):
        attn, pool = self.attention.forward_decode_paged(
            self.ln_1(x), pool, page_table, lengths)
        x = x + attn
        x = x + self.ff(self.ln_2(x))
        return x, pool

    def forward_extend_paged(self, x: Array, pool: dict, page_table: Array,
                             lengths: Array):
        attn, pool = self.attention.forward_extend_paged(
            self.ln_1(x), pool, page_table, lengths)
        x = x + attn
        x = x + self.ff(self.ln_2(x))
        return x, pool

    def forward_prefill_paged(self, x: Array, pool: dict, page_table: Array,
                              prompt_lens: Array):
        attn, pool = self.attention.forward_prefill_paged(
            self.ln_1(x), pool, page_table, prompt_lens)
        x = x + attn
        x = x + self.ff(self.ln_2(x))
        return x, pool


class DecoderLM(Module):
    """Decoder-only pre-LN transformer LM (reference :365-470).

    token+position embeddings -> dropout -> n_layer TransformerLayers ->
    final LN -> lm_head.
    """

    def __init__(self, n_vocab: int, n_embd: int, n_head: int, n_positions: int,
                 p_dropout: float = 0.1, ln_eps: float = 1e-5, bias: bool = True, *,
                 n_layer: int = 4,
                 middle_dim: int = 256,
                 n_kv_head: Optional[int] = None,
                 attn_impl: AttnImpl = "flash",
                 pos_encoding: str = "learned", rope_theta: float = 10000.0,
                 window: Optional[int] = None,
                 n_experts: Optional[int] = None, moe_top_k: int = 2,
                 remat: bool = False, remat_policy: str = "nothing",
                 key: jax.Array, dtype=jnp.float32):
        self.n_embd = n_embd
        self.n_vocab = n_vocab
        self.n_positions = n_positions
        # jax.checkpoint per transformer block: trade ~1/3 extra forward
        # flops for O(n_layer) fewer saved activations -- the long-sequence
        # memory lever (residuals otherwise scale with B*S*E*n_layer).
        self.remat = remat
        self.remat_policy = remat_policy
        # "learned": the reference's absolute position-embedding table
        # (sized by n_positions, fixing modules_transfomer.py:408 which sizes
        # it by n_vocab).  "rope": rotary embeddings applied to q/k inside
        # every attention path — no table, no length cap from the table.
        assert pos_encoding in ("learned", "rope")
        self.pos_encoding = pos_encoding
        keys = jax.random.split(key, n_layer + 3)
        self.token_embeddings = Embedding(n_vocab, n_embd, key=keys[0], dtype=dtype)
        if pos_encoding == "learned":
            self.position_embeddings = Embedding(n_positions, n_embd,
                                                 key=keys[1], dtype=dtype)
        self.layers = [
            TransformerLayer(
                n_embd, n_head, p_dropout, ln_eps, bias,
                middle_dim=middle_dim, n_kv_head=n_kv_head,
                attn_impl=attn_impl,
                pos_encoding="rope" if pos_encoding == "rope" else "none",
                rope_theta=rope_theta, window=window,
                n_experts=n_experts, moe_top_k=moe_top_k,
                key=keys[2 + i], dtype=dtype,
            )
            for i in range(n_layer)
        ]
        self.dropout = Dropout(p_dropout)
        self.ln = LayerNorm1d(n_embd, ln_eps, dtype=dtype)
        self.lm_head = Linear(n_embd, n_vocab, bias, key=keys[-1], dtype=dtype)

    def _embed(self, idx: Array, pos: Array) -> Array:
        x = self.token_embeddings(idx)
        if self.pos_encoding == "learned":
            x = x + self.position_embeddings(pos)
        return x  # rope: positions enter inside attention, not here

    def forward(self, idx: Array, key: Optional[jax.Array] = None) -> Array:
        """(B,S) int32 token ids -> (B,S,n_vocab) logits."""
        return self.forward_with_aux(idx, key=key)[0]

    def forward_with_aux(self, idx: Array,
                         key: Optional[jax.Array] = None):
        """(logits, aux): summed MoE load-balancing loss across layers
        (0 for dense models) — add ``alpha * aux`` to the training loss.
        ``forward`` is this with the aux dropped (single body)."""
        bs, seq = idx.shape
        pos = jnp.arange(seq, dtype=jnp.int32)[None, :]
        x = self._embed(idx, pos)
        keys = _split(key, len(self.layers) + 1)
        x = self.dropout(x, key=keys[0])
        aux = jnp.float32(0.0)
        step = lambda layer, x, k: layer.forward_with_aux(x, key=k)
        if self.remat:
            step = jax.checkpoint(step, policy=remat_policy(self.remat_policy))
        for layer, k in zip(self.layers, keys[1:]):
            x, a = step(layer, x, k)
            aux = aux + a
        x = self.ln(x)
        return self.lm_head(x), aux

    # -- KV-cached decoding --------------------------------------------------

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=jnp.float32) -> list:
        max_len = max_len or self.n_positions
        return [layer.attention.init_cache(batch, max_len, dtype)
                for layer in self.layers]

    def forward_decode(self, idx_tok: Array, caches: list, index: Array):
        """One decode step.  idx_tok: (B, 1) int ids at position ``index``.

        Returns (logits (B, 1, n_vocab), updated caches).
        """
        pos = jnp.asarray(index, jnp.int32).reshape(1, 1)
        x = self._embed(idx_tok, pos)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.forward_decode(x, cache, index)
            new_caches.append(cache)
        x = self.ln(x)
        return self.lm_head(x), new_caches

    # -- paged decoding (serving: continuous batching over page pools) ------

    def init_page_pools(self, total_pages: int, page_size: int,
                        dtype=jnp.float32) -> list:
        return [layer.attention.init_page_pool(total_pages, page_size, dtype)
                for layer in self.layers]

    def forward_decode_paged(self, idx_tok: Array, pools: list,
                             page_table: Array, lengths: Array):
        """One decode step over paged KV pools with PER-SEQUENCE positions.

        idx_tok: (B, 1) int ids; lengths: (B,) tokens already cached (the new
        token's position).  Returns (logits (B, 1, n_vocab), updated pools).
        """
        pos = lengths.astype(jnp.int32)[:, None]           # (B, 1)
        x = self._embed(idx_tok, pos)
        new_pools = []
        for layer, pool in zip(self.layers, pools):
            x, pool = layer.forward_decode_paged(x, pool, page_table, lengths)
            new_pools.append(pool)
        x = self.ln(x)
        return self.lm_head(x), new_pools

    def forward_extend_paged(self, tokens: Array, pools: list,
                             page_table: Array, lengths: Array):
        """Multi-token decode: tokens (B, k) extend each sequence at
        positions ``lengths + j`` in one pass.  Returns (logits (B, k,
        n_vocab), pools) — logits[:, j] predicts the token after position
        ``lengths + j`` (speculative verification reads the whole row)."""
        bs, kk = tokens.shape
        pos = lengths.astype(jnp.int32)[:, None] + jnp.arange(
            kk, dtype=jnp.int32)[None]
        # the padding of a chunked-prefill wave may run past the position
        # table; an out-of-range lookup fills NaN, and a NaN key or value
        # written into a page poisons every later read of it (a masked
        # score is zeroed, but 0 * NaN in the value product is not)
        x = self._embed(tokens, jnp.minimum(pos, self.n_positions - 1))
        new_pools = []
        for layer, pool in zip(self.layers, pools):
            x, pool = layer.forward_extend_paged(x, pool, page_table, lengths)
            new_pools.append(pool)
        x = self.ln(x)
        return self.lm_head(x), new_pools

    def forward_prefill_paged(self, tokens: Array, pools: list,
                              page_table: Array, prompt_lens: Array):
        """Batched prefill: tokens (B, S) padded prompts; writes every
        position's K/V into the pages and returns (logits (B, S, n_vocab),
        pools).  Rows with prompt_lens == 0 are idle (route their table to a
        trash page)."""
        bs, seq = tokens.shape
        pos = jnp.arange(seq, dtype=jnp.int32)[None, :]
        x = self._embed(tokens, pos)
        new_pools = []
        for layer, pool in zip(self.layers, pools):
            x, pool = layer.forward_prefill_paged(x, pool, page_table,
                                                  prompt_lens)
            new_pools.append(pool)
        x = self.ln(x)
        return self.lm_head(x), new_pools
