"""Mixture-of-Experts feed-forward (Switch/GShard-style) + expert parallelism.

No reference equivalent (dense FFN only, modules_transfomer.py:233-276);
this is the "ep" axis of the parallelism surface.  Design:

* static shapes end to end: capacity-based dispatch (each expert processes
  at most ``capacity`` tokens per batch; overflow tokens fall through the
  residual connection, the standard Switch behaviour) — no sorting, no
  dynamic gather; the dispatch/combine are one-hot einsums (dense matmuls);
* expert weights are stacked arrays ``(E, d, m)`` / ``(E, m, d)`` so the
  per-expert FFN is ONE batched matmul, and expert parallelism is just a
  sharding annotation ``P(expert_axis, None, None)`` — GSPMD inserts the
  all-to-alls around the dispatch einsums;
* top-1 or top-2 routing with the Switch load-balancing auxiliary loss
  (``aux = E * mean(gate_frac * token_frac)``), surfaced functionally via
  ``forward_with_aux`` so jitted training can add it to the objective.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..module import Module
from ..nn import functional as F
from ..nn.basic import Linear

Array = jax.Array


class MoEFeedForward(Module):
    """Token-routed expert GELU MLPs replacing a dense FeedForward."""

    def __init__(self, n_embd: int, middle_dim: int, n_experts: int, *,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 p_dropout: float = 0.0,
                 key: jax.Array, dtype=jnp.float32):
        assert top_k in (1, 2)
        self.n_embd = n_embd
        self.middle_dim = middle_dim
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        from ..nn.basic import Dropout

        self.dropout = Dropout(p_dropout)
        kr, ki, ko = jax.random.split(key, 3)
        self.router = Linear(n_embd, n_experts, bias=False, key=kr,
                             dtype=dtype)
        # same +-1/sqrt(in) init as Linear, stacked over experts
        bound_i = 1.0 / math.sqrt(n_embd)
        bound_o = 1.0 / math.sqrt(middle_dim)
        self.experts_in = jax.random.uniform(
            ki, (n_experts, n_embd, middle_dim), dtype, -bound_i, bound_i)
        self.experts_out = jax.random.uniform(
            ko, (n_experts, middle_dim, n_embd), dtype, -bound_o, bound_o)

    def _capacity(self, n_tokens: int) -> int:
        if not self.training:
            # dropless at inference: capacity drops are a TRAINING
            # throughput/balance trade-off, but at eval they make outputs
            # depend on what else is in the batch — cached decode would
            # diverge from the full forward.  n_tokens slots suffice: the
            # top-k choices per token are DISTINCT experts, so one expert
            # receives at most n_tokens assignments.
            return n_tokens
        cap = int(math.ceil(n_tokens * self.top_k * self.capacity_factor
                            / self.n_experts))
        return max(cap, self.top_k)

    def forward_with_aux(self, x: Array,
                         key: Optional[jax.Array] = None
                         ) -> Tuple[Array, Array]:
        """x (..., S, d) -> (y, aux_loss).  Routing is per token."""
        orig_shape = x.shape
        d = orig_shape[-1]
        xt = x.reshape(-1, d)                        # (T, d)
        t = xt.shape[0]
        e = self.n_experts
        cap = self._capacity(t)

        # Router runs at HIGHEST matmul precision: the default f32 matmul
        # may run in TF32 on a GPU (bf16 passes elsewhere), which perturbs
        # logits differently per batch shape, and a
        # near-tie argmax flip between prefill and decode routes the same
        # token to a different expert — discrete, so the outputs diverge
        # wholesale, not by epsilon.  The router is (T, d)x(d, E): tiny.
        logits = jax.lax.dot_general(
            xt.astype(jnp.float32),
            self.router.weights.astype(jnp.float32),
            (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST)             # (T, E)
        probs = jax.nn.softmax(logits, -1)

        combine = jnp.zeros((t, e, cap), jnp.float32)
        gate_sum = jnp.zeros((t,), jnp.float32)
        top_mask = jnp.zeros((t, e), jnp.float32)
        masked = probs
        for _ in range(self.top_k):
            idx = jnp.argmax(masked, -1)                     # (T,)
            onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
            gate = jnp.sum(probs * onehot, -1)               # (T,)
            # position of each token within its chosen expert's capacity
            pos = (jnp.cumsum(onehot, axis=0) - onehot) \
                + jnp.sum(top_mask, axis=0)[None]            # prior slots
            pos = jnp.sum(pos * onehot, -1).astype(jnp.int32)  # (T,)
            keep = (pos < cap).astype(jnp.float32)
            gate = gate * keep
            combine = combine + (onehot * gate[:, None])[:, :, None] \
                * jax.nn.one_hot(pos, cap, dtype=jnp.float32)[:, None, :]
            gate_sum = gate_sum + gate
            top_mask = top_mask + onehot
            masked = masked * (1.0 - onehot)                 # exclude chosen

        if self.top_k > 1:
            # renormalise the kept gates (Mixtral convention): the router
            # still gets task gradient through the RELATIVE weighting
            denom = jnp.maximum(gate_sum, 1e-9)[:, None, None]
            combine = combine / denom
        # top-1 keeps the RAW gate (Switch): renormalising would make the
        # multiplier exactly 1 and kill the router's task-loss gradient
        # (routing would then learn from the aux loss alone)
        dispatch = (combine > 0.0).astype(xt.dtype)          # (T, E, cap)

        expert_in = jnp.einsum("tec,td->ecd", dispatch, xt)  # (E, cap, d)
        h = F.GELU(jnp.einsum("ecd,edm->ecm", expert_in, self.experts_in))
        expert_out = jnp.einsum("ecm,emd->ecd", h, self.experts_out)
        y = jnp.einsum("tec,ecd->td", combine.astype(xt.dtype), expert_out)

        # Switch aux loss: E * sum_e mean_t(router_prob_e) * frac_tokens_e
        frac_tokens = jnp.mean(top_mask, axis=0) / self.top_k
        frac_probs = jnp.mean(probs, axis=0)
        aux = jnp.sum(frac_tokens * frac_probs) * e

        y = self.dropout(y.reshape(orig_shape), key=key)
        return y, aux

    def forward(self, x: Array, key: Optional[jax.Array] = None) -> Array:
        return self.forward_with_aux(x, key)[0]
