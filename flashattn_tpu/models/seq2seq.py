"""Encoder-decoder (seq2seq) transformer family.

The reference ships only a decoder-only LM and runs machine translation by
concatenating source+target into one causal stream
(``modules_transfomer.py:365-470``, ``run_machine_translation.py:90-161``);
this module supplies the encoder-decoder counterpart:

* :class:`EncoderLayer` — pre-LN bidirectional self-attention block; padded
  source batches are masked *in-kernel* via the varlen flash attention
  (``kv_lengths``), never as a materialised (B,H,S,S) mask.
* :class:`CrossDecoderLayer` — causal self-attention + cross-attention over
  the encoder memory + FFN, each pre-LN with a residual.
* :class:`EncoderDecoderLM` — embeddings -> encoder stack -> decoder stack
  -> lm_head, with a KV-cached decode path: the decoder's self-attention
  cache works exactly like :class:`DecoderLM`'s, and the cross-attention
  K/V are projected ONCE from the memory (`precompute_cross`) and reused
  every step — the standard inference factorisation the reference's
  O(len^2) re-run loop lacks (run_machine_translation.py:300-323).

All attention runs through :class:`MultiHeadAttention`, so the attn_impl
dispatch ("flash" / "cudnn" / "triton" / "fused_softmax" / "reference"), GQA, and the TP sharding
suffix rules (q/k/v/out_projection) apply unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..module import Module
from ..nn.basic import Dropout, Embedding, LayerNorm1d, Linear
from .transformer import (AttnImpl, FeedForward, MultiHeadAttention, _split,
                          remat_policy)

Array = jax.Array


class EncoderLayer(Module):
    """Pre-LN bidirectional transformer block for the encoder stack."""

    def __init__(self, n_embd: int, n_head: int, p_dropout: float = 0.1,
                 ln_eps: float = 1e-5, bias: bool = True, *,
                 middle_dim: int = 256, n_kv_head: Optional[int] = None,
                 attn_impl: AttnImpl = "flash",
                 key: jax.Array, dtype=jnp.float32):
        ka, kf = jax.random.split(key)
        self.attention = MultiHeadAttention(
            n_embd, n_head, causal=False, p_dropout=p_dropout, bias=bias,
            n_kv_head=n_kv_head, attn_impl=attn_impl, key=ka, dtype=dtype)
        self.ff = FeedForward(n_embd, middle_dim, p_dropout, bias, key=kf,
                              dtype=dtype)
        self.ln_1 = LayerNorm1d(n_embd, ln_eps, dtype=dtype)
        self.ln_2 = LayerNorm1d(n_embd, ln_eps, dtype=dtype)

    def forward(self, x: Array, src_lens: Optional[Array] = None,
                key: Optional[jax.Array] = None) -> Array:
        k1, k2 = _split(key, 2)
        x = x + self.attention(self.ln_1(x), key=k1, kv_lengths=src_lens)
        x = x + self.ff(self.ln_2(x), key=k2)
        return x


class CrossDecoderLayer(Module):
    """Pre-LN decoder block: causal self-attn -> cross-attn -> FFN."""

    def __init__(self, n_embd: int, n_head: int, p_dropout: float = 0.1,
                 ln_eps: float = 1e-5, bias: bool = True, *,
                 middle_dim: int = 256, n_kv_head: Optional[int] = None,
                 attn_impl: AttnImpl = "flash",
                 key: jax.Array, dtype=jnp.float32):
        ks, kc, kf = jax.random.split(key, 3)
        self.attention = MultiHeadAttention(
            n_embd, n_head, causal=True, p_dropout=p_dropout, bias=bias,
            n_kv_head=n_kv_head, attn_impl=attn_impl, key=ks, dtype=dtype)
        self.cross_attention = MultiHeadAttention(
            n_embd, n_head, causal=False, p_dropout=p_dropout, bias=bias,
            n_kv_head=n_kv_head, attn_impl=attn_impl, key=kc, dtype=dtype)
        self.ff = FeedForward(n_embd, middle_dim, p_dropout, bias, key=kf,
                              dtype=dtype)
        self.ln_1 = LayerNorm1d(n_embd, ln_eps, dtype=dtype)
        self.ln_c = LayerNorm1d(n_embd, ln_eps, dtype=dtype)
        self.ln_2 = LayerNorm1d(n_embd, ln_eps, dtype=dtype)

    def forward(self, x: Array, memory: Array,
                memory_lens: Optional[Array] = None,
                key: Optional[jax.Array] = None) -> Array:
        k1, k2, k3 = _split(key, 3)
        x = x + self.attention(self.ln_1(x), key=k1)
        x = x + self.cross_attention(self.ln_c(x), key=k2, kv=memory,
                                     kv_lengths=memory_lens)
        x = x + self.ff(self.ln_2(x), key=k3)
        return x

    # -- cached decode -------------------------------------------------------

    def precompute_cross(self, memory: Array) -> Tuple[Array, Array]:
        """Project the encoder memory to cross K/V once per generation."""
        _, k, v = self.cross_attention.project_to_query_key_value(
            memory[:, :1], memory)  # q is a dummy 1-token slice
        return k, v

    def forward_decode(self, x: Array, cache: dict, index: Array,
                       cross_k: Array, cross_v: Array,
                       memory_lens: Optional[Array] = None):
        attn, cache = self.attention.forward_decode(self.ln_1(x), cache, index)
        x = x + attn
        ca = self.cross_attention
        q, _, _ = ca.project_to_query_key_value(self.ln_c(x))
        x = x + ca.out_projection(
            ca.self_attention(q, cross_k, cross_v, kv_lengths=memory_lens))
        x = x + self.ff(self.ln_2(x))
        return x, cache


class EncoderDecoderLM(Module):
    """Full encoder-decoder LM over a shared vocabulary.

    ``forward(src, tgt)`` returns next-token logits over the target (teacher
    forcing); ``encode`` / ``init_cache`` / ``precompute_cross`` /
    ``forward_decode`` factor generation into one encoder pass + one cross
    K/V projection + cached per-token decode steps.
    """

    def __init__(self, n_vocab: int, n_embd: int, n_head: int,
                 n_positions: int, p_dropout: float = 0.1,
                 ln_eps: float = 1e-5, bias: bool = True, *,
                 n_encoder_layer: int = 4, n_decoder_layer: int = 4,
                 middle_dim: int = 256, n_kv_head: Optional[int] = None,
                 attn_impl: AttnImpl = "flash",
                 remat: bool = False, remat_policy: str = "nothing",
                 key: jax.Array, dtype=jnp.float32):
        self.n_embd = n_embd
        self.n_vocab = n_vocab
        self.n_positions = n_positions
        # jax.checkpoint per encoder/decoder block (see transformer.py).
        self.remat = remat
        self.remat_policy = remat_policy
        n = n_encoder_layer + n_decoder_layer
        keys = jax.random.split(key, n + 4)
        self.token_embeddings = Embedding(n_vocab, n_embd, key=keys[0],
                                          dtype=dtype)
        self.position_embeddings = Embedding(n_positions, n_embd, key=keys[1],
                                             dtype=dtype)
        self.encoder_layers = [
            EncoderLayer(n_embd, n_head, p_dropout, ln_eps, bias,
                         middle_dim=middle_dim, n_kv_head=n_kv_head,
                         attn_impl=attn_impl,
                         key=keys[2 + i], dtype=dtype)
            for i in range(n_encoder_layer)
        ]
        self.decoder_layers = [
            CrossDecoderLayer(n_embd, n_head, p_dropout, ln_eps, bias,
                              middle_dim=middle_dim, n_kv_head=n_kv_head,
                              attn_impl=attn_impl,
                                   key=keys[2 + n_encoder_layer + i], dtype=dtype)
            for i in range(n_decoder_layer)
        ]
        self.dropout = Dropout(p_dropout)
        self.ln_enc = LayerNorm1d(n_embd, ln_eps, dtype=dtype)
        self.ln = LayerNorm1d(n_embd, ln_eps, dtype=dtype)
        self.lm_head = Linear(n_embd, n_vocab, bias, key=keys[-1], dtype=dtype)

    def _embed(self, idx: Array, key) -> Array:
        pos = jnp.arange(idx.shape[1], dtype=jnp.int32)[None, :]
        x = self.token_embeddings(idx) + self.position_embeddings(pos)
        return self.dropout(x, key=key)

    def encode(self, src: Array, src_lens: Optional[Array] = None,
               key: Optional[jax.Array] = None) -> Array:
        """(B, S_src) ids -> (B, S_src, E) memory (padded rows are garbage
        but never read: every consumer masks via the lengths)."""
        keys = _split(key, len(self.encoder_layers) + 1)
        x = self._embed(src, keys[0])
        step = lambda layer, x, k: layer(x, src_lens, key=k)
        if self.remat:
            step = jax.checkpoint(step, policy=remat_policy(self.remat_policy))
        for layer, k in zip(self.encoder_layers, keys[1:]):
            x = step(layer, x, k)
        return self.ln_enc(x)

    def decode(self, tgt: Array, memory: Array,
               src_lens: Optional[Array] = None,
               key: Optional[jax.Array] = None) -> Array:
        keys = _split(key, len(self.decoder_layers) + 1)
        x = self._embed(tgt, keys[0])
        step = lambda layer, x, k: layer(x, memory, src_lens, key=k)
        if self.remat:
            step = jax.checkpoint(step, policy=remat_policy(self.remat_policy))
        for layer, k in zip(self.decoder_layers, keys[1:]):
            x = step(layer, x, k)
        return self.lm_head(self.ln(x))

    def forward(self, src: Array, tgt: Array,
                src_lens: Optional[Array] = None,
                key: Optional[jax.Array] = None) -> Array:
        """(B,S_src), (B,S_tgt) -> (B,S_tgt,n_vocab) logits."""
        ke, kd = _split(key, 2)
        memory = self.encode(src, src_lens, key=ke)
        return self.decode(tgt, memory, src_lens, key=kd)

    # -- cached generation ---------------------------------------------------

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=jnp.float32) -> list:
        max_len = max_len or self.n_positions
        return [layer.attention.init_cache(batch, max_len, dtype)
                for layer in self.decoder_layers]

    def precompute_cross(self, memory: Array) -> List[Tuple[Array, Array]]:
        return [layer.precompute_cross(memory)
                for layer in self.decoder_layers]

    def forward_decode(self, tok: Array, caches: list, cross_kvs: list,
                       index: Array, src_lens: Optional[Array] = None):
        """One decode step.  tok (B,1) ids at target position ``index``."""
        pos = jnp.asarray(index, jnp.int32).reshape(1, 1)
        x = self.token_embeddings(tok) + self.position_embeddings(pos)
        new_caches = []
        for layer, cache, (ck, cv) in zip(self.decoder_layers, caches,
                                          cross_kvs):
            x, cache = layer.forward_decode(x, cache, index, ck, cv, src_lens)
            new_caches.append(cache)
        return self.lm_head(self.ln(x)), new_caches
