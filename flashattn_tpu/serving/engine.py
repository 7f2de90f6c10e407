"""Continuous-batching decode engine over a paged KV cache.

Serving-path capability with no reference equivalent (the reference's
generation re-runs the full model per token per example,
run_machine_translation.py:300-323): a paged KV-cache and continuous
batching.

Design (vLLM-style scheduling, static-shape execution):

* the DEVICE step is one static-shape jitted program: every slot of a fixed
  max_batch decodes one token against per-layer page pools
  (``DecoderLM.forward_decode_paged`` → the Pallas paged-attention kernel,
  whose dynamic length loop means empty/short slots cost only the pages they
  actually have);
* the HOST scheduler (this module, plain numpy — no device sync beyond the
  sampled tokens) admits queued requests into free slots mid-flight, allocates
  physical pages from a free list as sequences cross page boundaries, and
  retires finished sequences, returning their pages to the pool;
* admission runs ONE batched prefill dispatch over the newly admitted
  slots (varlen flash attention; all prompt positions' K/V scatter into
  their pages), then slots join the decode step; prompt lengths bucket to
  powers of two so the prefill jit cache stays small.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


# Randomness substreams per (request seed, absolute position): plain
# sampling, speculative acceptance uniforms, speculative residual sampling.
_SALT_SAMPLE, _SALT_ACCEPT, _SALT_RESIDUAL = 0, 1, 2


def _row_keys(seeds, pos, salt):
    """(B,) per-row PRNG keys derived from (request seed, absolute token
    position, substream salt) — sampling randomness is a pure function of
    the REQUEST, so a sampled request's output is reproducible and
    independent of which other requests share its batch.  (Speculative
    waves draw from the ACCEPT/RESIDUAL substreams, and wave *eligibility*
    is batch-global — so the strict independence guarantee holds for
    non-speculative engines; with speculation the per-token marginals are
    unchanged but neighbors can shift which substream a token drew from.)"""
    def one(s, p):
        k = jax.random.fold_in(jax.random.PRNGKey(s), p)
        return jax.random.fold_in(k, salt)

    return jax.vmap(one)(seeds, pos)


def _row_gumbel(seeds, pos, salt, v):
    """(B, V) gumbel noise from per-row keys: argmax(logits + gumbel) is an
    exact per-row categorical draw (the Gumbel-max trick), replacing the
    batch-global jax.random.categorical."""
    keys = _row_keys(seeds, pos, salt)
    return jax.vmap(lambda k: jax.random.gumbel(k, (v,), jnp.float32))(keys)


def _sample_tokens(logits, temps, topks, topps, seeds, pos, *,
                   greedy_only: bool = False,
                   presence=None, reps=None, minps=None,
                   freqs=None, press=None):
    """Per-row sampling: temperature 0 -> greedy; top_k 0 -> unrestricted;
    top_p 0 (or 1) -> no nucleus cut; min_p 0 -> no min-p cut; repetition
    penalty (HF rule) plus OpenAI-style frequency/presence penalties when
    ``presence``/``reps``/``freqs``/``press`` are given.

    logits (B, V); temps (B,) f32; topks (B,) int32; topps/minps (B,) f32;
    seeds (B,) int32 per-request sampling seeds; pos (B,) int32 absolute
    position of the token being sampled (randomness = f(seed, pos), see
    :func:`_row_keys`); presence (B, V) f32 counts of already-seen tokens
    (prompt + generated); reps (B,) f32 (1.0 = off); freqs/press (B,) f32
    (0.0 = off) subtract ``freq*count + pres*(count>0)`` from seen tokens'
    logits (additive, unlike the multiplicative HF rule).  Full-sort
    top-k/top-p keeps per-row parameters dynamic (fine at LM-head scales;
    ONE sort serves both cuts per dispatch; min-p needs no sort at all).
    ``greedy_only`` (static) skips the sort+sampling entirely — the host
    scheduler passes it when every active request has temperature 0, so
    the common greedy workload never pays the V·log V sort in the decode
    loop.
    """
    if presence is not None:
        # HF repetition penalty: for seen tokens, positive logits divide by
        # the penalty, non-positive multiply (both push probability down)
        pen = jnp.maximum(reps, 1e-6)[:, None]
        adj = jnp.where(logits > 0, logits / pen, logits * pen)
        logits = jnp.where((presence > 0) & (pen != 1.0), adj, logits)
        if freqs is not None:
            logits = logits - (freqs[:, None] * presence
                               + press[:, None] * (presence > 0))
    greedy = jnp.argmax(logits, -1).astype(jnp.int32)
    if greedy_only:
        return greedy
    v = logits.shape[-1]
    sorted_desc = jnp.sort(logits, axis=-1)[:, ::-1]
    k_idx = jnp.clip(jnp.where(topks > 0, topks, v) - 1, 0, v - 1)
    thresh = jnp.take_along_axis(sorted_desc, k_idx[:, None], axis=1)
    # nucleus (top-p) over the RENORMALISED top-k survivors (standard
    # HF/vLLM sequential semantics).  The survivors are exactly the sorted
    # prefix, so one sort serves both cuts: positions >= k collapse to
    # -inf before the softmax, and the cutoff is the smallest prefix of
    # the temperature-scaled survivor distribution reaching mass p
    # (`cum - p_i < p` always keeps the top-1 token).  Rows with top_p
    # disabled get a -inf threshold.
    temp_safe = jnp.maximum(temps, 1e-6)[:, None]
    in_k = jnp.arange(v)[None, :] <= k_idx[:, None]
    sorted_surv = jnp.where(in_k, sorted_desc, -jnp.inf)
    p_sorted = jax.nn.softmax(sorted_surv / temp_safe, axis=-1)
    cum = jnp.cumsum(p_sorted, axis=-1)
    keep_sorted = (cum - p_sorted) < topps[:, None]
    cnt = jnp.maximum(jnp.sum(keep_sorted & in_k, axis=-1), 1)
    p_thresh = jnp.take_along_axis(sorted_desc, (cnt - 1)[:, None], axis=1)
    p_on = (topps > 0.0) & (topps < 1.0)
    p_thresh = jnp.where(p_on[:, None], p_thresh, -jnp.inf)
    keep = (logits >= thresh) & (logits >= p_thresh)
    if minps is not None:
        # min-p: drop tokens whose temperature-scaled probability is below
        # min_p * p_max; equivalent threshold in logit space is
        # max_logit + T*log(min_p), so no extra softmax/sort is needed
        m_on = minps > 0.0
        mp_thresh = (jnp.max(logits, axis=-1, keepdims=True)
                     + temp_safe * jnp.log(jnp.maximum(minps, 1e-9))[:, None])
        keep &= (logits >= mp_thresh) | ~m_on[:, None]
    masked = jnp.where(keep, logits, -jnp.inf)
    scaled = masked / temp_safe
    g = _row_gumbel(seeds, pos, _SALT_SAMPLE, v)
    sampled = jnp.argmax(scaled + g, axis=-1).astype(jnp.int32)
    return jnp.where(temps > 0, sampled, greedy)


def _token_logprob(logits, toks):
    """(B,) log p of ``toks`` under the raw model distribution (f32
    log-softmax of the pre-penalty, pre-temperature logits)."""
    lps = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return jnp.take_along_axis(lps, toks[:, None], axis=-1)[:, 0]


def _spec_accept_sampled(logits, proposed, temps, seeds, pos0):
    """Exact speculative SAMPLING acceptance for a deterministic proposal
    (Leviathan et al. with a point-mass draft): at each position accept the
    proposed token d with probability p(d) under the temperature-scaled
    target distribution; on the first rejection sample from the residual
    (p with d's mass removed, renormalised) — the landed tokens' marginal
    distribution is EXACTLY the target's, position by position.  Rows with
    temperature 0 use argmax acceptance (the deterministic limit).

    logits (B, n, V) target logits over the chunk; proposed (B, n-1)
    drafted tokens (-1 pads never accepted); temps (B,) f32; seeds (B,)
    int32 per-request sampling seeds; pos0 (B,) int32 absolute position of
    the wave's first landed token (randomness = f(seed, position), see
    :func:`_row_keys`).  Returns (n_acc (B,) accepted-proposal counts,
    toks (B, n) with the landed tokens in positions 0..n_acc, lps (B, n)
    raw-model logprobs of toks).
    """
    b, n, v = logits.shape
    k = n - 1
    lf = logits.astype(jnp.float32)
    lps_raw = jax.nn.log_softmax(lf, -1)
    greedy = jnp.argmax(lf, -1).astype(jnp.int32)          # (B, n)
    t_on = temps > 0
    logp_t = jax.nn.log_softmax(lf / jnp.maximum(temps, 1e-6)[:, None, None],
                                -1)

    def row_u(s, p0):
        def at(t):
            kk = jax.random.fold_in(jax.random.PRNGKey(s), p0 + t)
            return jax.random.uniform(jax.random.fold_in(kk, _SALT_ACCEPT))
        return jax.vmap(at)(jnp.arange(k))

    u = jax.vmap(row_u)(seeds, pos0)                       # (B, k)
    prop_safe = jnp.maximum(proposed, 0)
    p_prop = jnp.exp(jnp.take_along_axis(
        logp_t[:, :k], prop_safe[..., None], -1)[..., 0])  # (B, k)
    accept = jnp.where(t_on[:, None], u < p_prop,
                       proposed == greedy[:, :k]) & (proposed >= 0)
    # accepted prefix length: stop at the first rejection
    n_acc = jnp.sum(jnp.cumprod(accept.astype(jnp.int32), -1), -1)  # (B,)
    # bonus/residual token at position n_acc: all-accepted rows sample the
    # target distribution directly; rejected rows zero the proposed token's
    # mass (categorical renormalises), which IS the point-mass residual
    logp_at = jnp.take_along_axis(
        logp_t, n_acc[:, None, None].repeat(v, -1), 1)[:, 0]   # (B, V)
    prop_pad = jnp.concatenate(
        [prop_safe, jnp.zeros((b, 1), jnp.int32)], 1)          # (B, n)
    rej_tok = jnp.take_along_axis(prop_pad, n_acc[:, None], 1)[:, 0]
    was_rej = n_acc < k
    res = jnp.where((jnp.arange(v)[None, :] == rej_tok[:, None])
                    & was_rej[:, None], -jnp.inf, logp_at)
    g = _row_gumbel(seeds, pos0 + n_acc, _SALT_RESIDUAL, v)
    sampled = jnp.argmax(res + g, -1).astype(jnp.int32)
    final = jnp.where(t_on,
                      sampled,
                      jnp.take_along_axis(greedy, n_acc[:, None], 1)[:, 0])
    idx = jnp.arange(n)[None, :]
    toks = jnp.where(idx < n_acc[:, None], prop_pad, 0)
    toks = jnp.where(idx == n_acc[:, None], final[:, None], toks)
    lps = jnp.take_along_axis(lps_raw, toks[..., None], -1)[..., 0]
    return n_acc, toks, lps


def _ngram_propose(ctx: List[int], k: int, max_ngram: int = 3) -> List[int]:
    """Prompt-lookup proposal: find the rightmost earlier occurrence of the
    context's trailing n-gram (longest n first) and propose the up-to-k
    tokens that followed it.  Draft-free speculation — on text with local
    repetition (code, MT, extraction) the continuation after a repeated
    n-gram is often what the model emits, and verification is the same
    greedy-exact chunk the draft path uses."""
    L = len(ctx)
    for n in range(max_ngram, 0, -1):
        if L <= n:
            continue
        pat = ctx[-n:]
        for s in range(L - n - 1, -1, -1):
            if ctx[s:s + n] == pat:
                # s <= L-n-1 guarantees at least one continuation token
                # (self-overlapping matches propose the repeat — standard)
                return ctx[s + n:s + n + k]
    return []


def _apply_stop(req: "Request") -> bool:
    """Trim ``req.generated`` at the earliest stop-sequence match (match
    kept in the output).  Returns True when a match ended the request.

    Incremental: only matches a token appended since the last scan could
    have COMPLETED are checked (no earlier match can exist — it would
    have retired the request in a prior step), so total work over a
    generation is linear, not quadratic."""
    if not req.stop or not req.generated:
        return False
    gen = req.generated
    max_n = max(len(s) for s in req.stop)
    scan_from = max(0, req._stop_scanned - max_n + 1)
    best = None
    for seq in req.stop:
        n = len(seq)
        if n == 0 or n > len(gen):
            continue
        for end in range(max(n, scan_from + n), len(gen) + 1):
            if gen[end - n:end] == seq:
                if best is None or end < best:
                    best = end
                break
    req._stop_scanned = len(gen)
    if best is None:
        return False
    del gen[best:]
    del req.token_logprobs[best:]
    req._streamed = min(req._streamed, len(gen))
    return True


class PagePool:
    """Host-side free list of physical page ids."""

    def __init__(self, total_pages: int):
        self.free: List[int] = list(range(total_pages - 1, -1, -1))
        self.total = total_pages

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError("page pool exhausted")
        return self.free.pop()

    def release(self, pages: List[int]) -> None:
        self.free.extend(pages)

    @property
    def n_free(self) -> int:
        return len(self.free)


@dataclasses.dataclass
class Request:
    """One generation request."""

    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    # sampling: 0 temperature = greedy; top_k limits candidates (None =
    # all); top_p keeps the smallest nucleus of mass >= p (None/1.0 = off)
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None  # drop tokens with p < min_p * p_max
    # per-request sampling seed: randomness is f(seed, position), so a
    # sampled request reproduces exactly regardless of batch composition
    # (None = derived from the engine seed + uid)
    seed: Optional[int] = None
    # HF-style repetition penalty over prompt+generated tokens (None/1.0 =
    # off; >1 discourages repeats). Applies to greedy decoding too.
    repetition_penalty: Optional[float] = None
    # OpenAI-style additive penalties over prompt+generated tokens
    # (None/0.0 = off): seen tokens' logits lose
    # frequency_penalty*count + presence_penalty. Apply to greedy too.
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    # stop sequences (token-id lists): generation ends when the tail of
    # ``generated`` equals one of them; the match is kept in the output.
    # Checked host-side per engine step, so chunked decode may overshoot
    # device-side — the overshoot is trimmed before callbacks/finish.
    stop: Optional[List[List[int]]] = None
    # filled by the engine:
    uid: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    # log p of each generated token under the RAW model distribution
    # (pre-penalty, pre-temperature log-softmax) — one float per entry of
    # ``generated``, kept in lockstep through stop-sequence trimming
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    # per-step next-token logits (engine built with collect_logits=True):
    # one row per consumed position, prefill included
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False  # stopped early (KV page pool exhausted)
    cancelled: bool = False  # engine.cancel() — pages freed, done=True
    # streaming: called as on_token(request, new_tokens) after each engine
    # step that landed tokens for this request (decode chunks deliver up to
    # steps_per_dispatch at once — device-side batching is not per-token)
    on_token: Optional[Callable[["Request", List[int]], None]] = None
    _streamed: int = 0  # tokens already delivered to on_token
    _stop_scanned: int = 0  # generated length already scanned for stops


@dataclasses.dataclass
class _Slot:
    request: Request
    pages: List[Optional[int]]  # None = released behind the sliding window
    length: int = 0          # tokens already in the KV cache
    next_input: int = 0      # token id to feed at position `length`
    shared_pages: int = 0    # leading pages attached from the prefix cache
    # repetition penalty: per-vocab counts of seen tokens (lazily built at
    # admit from the prompt, incremented as tokens land) + how many
    # generated tokens have been folded in
    presence: Optional[np.ndarray] = None
    presence_counted: int = 0


class ContinuousBatchingEngine:
    """Continuous-batching decoder for a :class:`DecoderLM`: paged KV
    pools, batched/chunked prefill, per-request sampling (temperature,
    top-k, top-p, min-p, repetition/frequency/presence penalties),
    per-token logprobs, stop sequences, streaming, cancellation, prefix
    caching and speculative decoding (draft-model or draft-free
    prompt-lookup).  Temperature-0 requests ride a greedy fast path that
    skips sampling entirely."""

    def __init__(self, model, *, max_batch: int = 8, page_size: int = 128,
                 pages_per_seq: int = 16, total_pages: Optional[int] = None,
                 dtype=jnp.float32, collect_logits: bool = False,
                 steps_per_dispatch: int = 8, mesh=None,
                 head_axis: str = "model", seed: int = 0,
                 draft_model=None, spec_len: int = 4,
                 spec_waves_per_dispatch: int = 4,
                 prompt_lookup: int = 0, lookup_max_ngram: int = 3,
                 prefill_chunk: int = 512,
                 enable_prefix_cache: bool = False):
        self.model = model.eval()
        self.mesh = mesh
        if mesh is not None:
            # TP-sharded serving: weights per the
            # Megatron rules, KV pools sharded over the heads axis, paged
            # attention under shard_map.
            from ..parallel.sharding import apply_mesh, shard_model

            m = apply_mesh(self.model, mesh, batch_axis=None,
                           head_axis=head_axis)
            self.model = shard_model(m, mesh, head_axis)
        self.max_batch = max_batch
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        total_pages = total_pages or max_batch * pages_per_seq
        self.pool = PagePool(total_pages)

        # One extra physical page (id = total_pages) absorbs the K/V writes
        # of INACTIVE slots: the device step is static-shape, so empty slots
        # still scatter their dummy token somewhere — without a trash page
        # they'd stomp physical page 0, which belongs to a live request.
        self._trash_page = total_pages
        self.pools = self.model.init_page_pools(total_pages + 1, page_size,
                                                dtype)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            pool_sharding = NamedSharding(mesh, P(head_axis, None, None, None))
            self.pools = jax.tree_util.tree_map(
                lambda a: jax.device_put(a, pool_sharding), self.pools)
        self.page_table = np.full((max_batch, pages_per_seq),
                                  self._trash_page, np.int32)
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self._seed = seed
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._uid = 0

        self.collect_logits = collect_logits
        self.steps_per_dispatch = steps_per_dispatch

        # Sliding-window model => rolling KV buffer: pages wholly behind
        # every window any layer can still read are returned to the pool,
        # so a long-running sequence holds ~window/page_size live pages and
        # the pool bound becomes concurrency * window, not * history.  (The
        # page-table columns stay absolute, so per-sequence LENGTH is still
        # capped at pages_per_seq * page_size — the win is pool sharing.)
        # Release uses the WIDEST window across layers (a mixed local/global
        # stack must keep pages for its global layers: any window=None layer
        # disables release); the windowed paged kernel starts its walk at
        # max(0, length+1-window)//page_size and _release_behind_window
        # frees strictly below that, so freed pages are never referenced.
        self._window = None
        layers = list(getattr(self.model, "layers", None) or [])
        if draft_model is not None:
            # the rolling release threshold must satisfy the WIDEST reader
            # across BOTH models (the draft walks the same page ids)
            layers += list(getattr(draft_model, "layers", None) or [])
        if layers:
            windows = [getattr(l.attention, "window", None) for l in layers]
            if windows and all(w is not None for w in windows):
                self._window = max(windows)

        # Speculative decoding (greedy-exact): a cheap draft model proposes
        # spec_len-1 tokens sequentially, the target verifies the whole
        # chunk in ONE multi-token pass (forward_extend_paged); the accepted
        # prefix plus the target's own next token land per wave, so the
        # expensive model runs once per ~n_accepted tokens instead of once
        # per token.  Greedy acceptance (draft token == target argmax) makes
        # the output IDENTICAL to plain greedy decoding.
        self.draft_model = None
        self.spec_len = spec_len
        # all-greedy batches scan this many waves per dispatch (device-side
        # acceptance) — the speculative analogue of steps_per_dispatch; 1
        # restores the single-wave host loop
        self.spec_waves_per_dispatch = spec_waves_per_dispatch
        self.spec_stats = [0, 0]   # [accepted tokens, waves]

        # Prompt-lookup (n-gram) speculation: draft-FREE proposals from the
        # request's own context (match the trailing n-gram, propose what
        # followed it last time), verified by the same greedy-exact
        # multi-token pass.  No draft model, no draft pools, no extra
        # prefill — the only cost is the wider verify dispatch.
        self.prompt_lookup = prompt_lookup
        self.lookup_max_ngram = lookup_max_ngram
        self.lookup_stats = [0, 0]  # [accepted tokens, waves]
        self._ngram_impl = None  # resolved lazily: native C++ or Python
        if prompt_lookup and draft_model is not None:
            raise ValueError("prompt_lookup and draft_model are mutually "
                             "exclusive speculation modes")
        if prompt_lookup and collect_logits:
            print("[engine] collect_logits disables speculative decoding; "
                  "ignoring prompt_lookup")
            self.prompt_lookup = 0
        if self.prompt_lookup:
            @functools.partial(jax.jit, donate_argnums=(1,))
            def _verify_step(model, pools, chunk, table, lengths):
                logits, pools = model.forward_extend_paged(
                    chunk, pools, table, lengths)
                greedy = jnp.argmax(logits, -1).astype(jnp.int32)  # (B, n)
                lps = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
                lps = jnp.take_along_axis(
                    lps, greedy[..., None], -1)[..., 0]
                return pools, greedy, lps

            self._jit_verify = _verify_step

            @functools.partial(jax.jit, donate_argnums=(1,))
            def _verify_sampled_step(model, pools, chunk, proposed, table,
                                     lengths, temps, seeds):
                # proposed = chunk[:, 1:] but with pad positions marked -1
                # (a 0 pad inside chunk must never be ACCEPTED as a token)
                logits, pools = model.forward_extend_paged(
                    chunk, pools, table, lengths)
                n_acc, toks, lps = _spec_accept_sampled(
                    logits, proposed, temps, seeds, lengths + 1)
                return pools, n_acc, toks, lps

            self._jit_verify_sampled = _verify_sampled_step

        if draft_model is not None and collect_logits:
            # _spec_ready is permanently False under collect_logits; keeping
            # the draft would pay a useless prefill dispatch per admission
            print("[engine] collect_logits disables speculative decoding; "
                  "ignoring draft_model")
            draft_model = None
        if draft_model is not None:
            self.draft_model = draft_model.eval()
            if mesh is not None:
                # speculative + TP serving: the draft shards over the SAME
                # (mesh, head_axis) as the target — its decode scan and the
                # target's verify pass then both run under shard_map with
                # head-sharded pools, one spec wave per dispatch as before
                from ..parallel.sharding import apply_mesh, shard_model

                dm = apply_mesh(self.draft_model, mesh, batch_axis=None,
                                head_axis=head_axis)
                self.draft_model = shard_model(dm, mesh, head_axis)
            self.draft_pools = self.draft_model.init_page_pools(
                total_pages + 1, page_size, dtype)
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                dp_sharding = NamedSharding(
                    mesh, P(head_axis, None, None, None))
                self.draft_pools = jax.tree_util.tree_map(
                    lambda a: jax.device_put(a, dp_sharding),
                    self.draft_pools)

            @functools.partial(jax.jit, donate_argnums=(2, 3),
                               static_argnames=("n_spec",))
            def _spec_step(tmodel, dmodel, tpools, dpools, tokens, table,
                           lengths, n_spec):
                def body(carry, _):
                    dpools, tok, lens = carry
                    logits, dpools = dmodel.forward_decode_paged(
                        tok[:, None], dpools, table, lens)
                    nxt = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
                    return (dpools, nxt, lens + 1), nxt

                # n_spec draft steps write positions L..L+n_spec-1 into the
                # draft pools (keeping them warm for the next wave) and emit
                # d_1..d_n; the chunk verifies [t, d_1..d_{n-1}]
                (dpools, _, _), drafts = jax.lax.scan(
                    body, (dpools, tokens, lengths), None, length=n_spec)
                chunk = jnp.concatenate([tokens[None], drafts[:-1]], 0).T
                logits, tpools = tmodel.forward_extend_paged(
                    chunk, tpools, table, lengths)
                greedy = jnp.argmax(logits, -1).astype(jnp.int32)  # (B, n)
                lps = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
                lps = jnp.take_along_axis(lps, greedy[..., None], -1)[..., 0]
                return tpools, dpools, drafts[:-1].T, greedy, lps

            self._jit_spec = _spec_step

            @functools.partial(jax.jit, donate_argnums=(2, 3),
                               static_argnames=("n_spec", "n_waves"))
            def _spec_scan(tmodel, dmodel, tpools, dpools, tokens, table,
                           lengths, n_spec, n_waves):
                """n_waves speculative waves in ONE dispatch: draft scan +
                multi-token verify + GREEDY acceptance all device-side, so
                the per-dispatch host cost amortises over every wave — the
                same lever
                steps_per_dispatch is for plain decode.  Rows advance by
                their own per-wave acceptance (ragged lengths are what the
                paged kernels are built for); the host epilogue lands
                n_land[w, i] tokens per wave and applies the usual
                retire/stop semantics (tokens past EOS are discarded — the
                overwritten pool positions beyond a row's length are inert,
                attention masks by length)."""
                B = tokens.shape[0]

                def wave(carry, _):
                    tpools, dpools, tok, lens = carry

                    def body(c, _):
                        dpools, t, l = c
                        logits, dpools = dmodel.forward_decode_paged(
                            t[:, None], dpools, table, l)
                        nxt = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
                        return (dpools, nxt, l + 1), nxt

                    (dpools, _, _), drafts = jax.lax.scan(
                        body, (dpools, tok, lens), None, length=n_spec)
                    chunk = jnp.concatenate([tok[None], drafts[:-1]], 0).T
                    logits, tpools = tmodel.forward_extend_paged(
                        chunk, tpools, table, lens)
                    greedy = jnp.argmax(logits, -1).astype(jnp.int32)
                    lps = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
                    lps = jnp.take_along_axis(
                        lps, greedy[..., None], -1)[..., 0]
                    # greedy acceptance: longest proposal prefix the target
                    # agrees with, plus the target's own next token
                    match = (drafts[:-1].T == greedy[:, :-1]).astype(jnp.int32)
                    acc = jnp.cumprod(match, axis=1).sum(1)     # (B,)
                    n_land = acc + 1
                    new_tok = greedy[jnp.arange(B), acc]
                    return ((tpools, dpools, new_tok, lens + n_land),
                            (greedy, lps, n_land))

                (tpools, dpools, _, _), (toks, lps, n_land) = jax.lax.scan(
                    wave, (tpools, dpools, tokens, lengths), None,
                    length=n_waves)
                return tpools, dpools, toks, lps, n_land

            self._jit_spec_scan = _spec_scan

            @functools.partial(jax.jit, donate_argnums=(2, 3),
                               static_argnames=("n_spec",))
            def _spec_sampled_step(tmodel, dmodel, tpools, dpools, tokens,
                                   table, lengths, temps, seeds, n_spec):
                # same draft scan; the target verify applies the exact
                # accept/residual rule (the argmax draft is a point-mass
                # proposal, so the lookup-wave math carries over verbatim)
                def body(carry, _):
                    dpools, tok, lens = carry
                    logits, dpools = dmodel.forward_decode_paged(
                        tok[:, None], dpools, table, lens)
                    nxt = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
                    return (dpools, nxt, lens + 1), nxt

                (dpools, _, _), drafts = jax.lax.scan(
                    body, (dpools, tokens, lengths), None, length=n_spec)
                chunk = jnp.concatenate([tokens[None], drafts[:-1]], 0).T
                logits, tpools = tmodel.forward_extend_paged(
                    chunk, tpools, table, lengths)
                n_acc, toks, lps = _spec_accept_sampled(
                    logits, drafts[:-1].T, temps, seeds, lengths + 1)
                return tpools, dpools, n_acc, toks, lps

            self._jit_spec_sampled = _spec_sampled_step

        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("greedy", "rep"))
        def _step(model, pools, tokens, table, lengths, temps, topks,
                  topps, minps, presence, reps, freqs, press, seeds, greedy,
                  rep):
            logits, pools = model.forward_decode_paged(
                tokens[:, None], pools, table, lengths)
            out = logits[:, 0] if collect_logits else None
            # pos = sequence index of the SAMPLED token (last consumed
            # index + 1); prefill's seed token sits at index lens, decode
            # tokens at lengths+1 — distinct keys for distinct tokens
            nxt = _sample_tokens(logits[:, 0], temps, topks, topps, seeds,
                                 lengths + 1, greedy_only=greedy,
                                 presence=presence if rep else None,
                                 reps=reps, minps=minps, freqs=freqs,
                                 press=press)
            return pools, nxt, _token_logprob(logits[:, 0], nxt), out

        self._jit_step = _step

        # Multi-step decode: when every active slot is past prefill and K
        # steps away from any scheduling event (page boundary, retirement),
        # scan K greedy steps device-side in ONE dispatch — each host
        # dispatch costs a launch, a result transfer and a host sync.
        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("n_steps", "greedy", "rep"))
        def _step_many(model, pools, tokens, table, lengths, temps, topks,
                       topps, minps, presence, reps, freqs, press, seeds,
                       n_steps, greedy, rep):
            def body(carry, _):
                pools, tokens, lengths, presence = carry
                logits, pools = model.forward_decode_paged(
                    tokens[:, None], pools, table, lengths)
                nxt = _sample_tokens(logits[:, 0], temps, topks, topps,
                                     seeds, lengths + 1, greedy_only=greedy,
                                     presence=presence if rep else None,
                                     reps=reps, minps=minps, freqs=freqs,
                                     press=press)
                if rep:  # newly sampled tokens join the seen set mid-chunk
                    presence = presence.at[
                        jnp.arange(presence.shape[0]), nxt].add(1.0)
                return ((pools, nxt, lengths + 1, presence),
                        (nxt, _token_logprob(logits[:, 0], nxt)))

            (pools, _, _, _), (sampled, lps) = jax.lax.scan(
                body, (pools, tokens, lengths, presence), None,
                length=n_steps)
            return pools, sampled, lps                 # sampled/lps: (K, B)

        self._jit_step_many = _step_many

        # Batched prefill: one dispatch consumes whole (padded) prompts —
        # vs the reference's per-token full-model re-runs
        # (run_machine_translation.py:300-323).
        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("greedy", "rep"))
        def _prefill_step(model, pools, tokens, table, lens, temps, topks,
                          topps, minps, presence, reps, freqs, press, seeds,
                          greedy, rep):
            logits, pools = model.forward_prefill_paged(tokens, pools, table,
                                                        lens)
            last = jnp.clip(lens - 1, 0, tokens.shape[1] - 1)
            chosen = jnp.take_along_axis(
                logits, last[:, None, None], axis=1)[:, 0]      # (B, V)
            sampled = _sample_tokens(chosen, temps, topks, topps, seeds,
                                     lens, greedy_only=greedy,
                                     presence=presence if rep else None,
                                     reps=reps, minps=minps, freqs=freqs,
                                     press=press)
            return (pools, sampled, _token_logprob(chosen, sampled),
                    (logits if collect_logits else None))

        self._jit_prefill = _prefill_step

        # Chunked prefill: prompts longer than ``prefill_chunk`` stream
        # through fixed-shape forward_extend_paged waves instead of one
        # giant padded dispatch — bounds the jit bucket sizes AND the
        # latency spike a long prompt injects into the serving loop.
        self.prefill_chunk = prefill_chunk

        # Prefix caching (opt-in): FULL pages of a prompt are content-
        # addressed (key = the token prefix through that page) and shared
        # read-only across requests — a request whose prompt prefix was
        # served before attaches to the cached pages and prefills only the
        # suffix (the chunked-prefill per-row base does the skipping).
        # Refcount = attached slots + 1 while registered; pages return to
        # the pool only at ref 0 (cache entries evict LRU when the pool is
        # dry).  Shared pages are write-once: suffix writes start at the
        # page boundary, and the last table column is never shared (the
        # final-wave scatter clamp may spill garbage there).
        self.enable_prefix_cache = (enable_prefix_cache
                                    and self._window is None
                                    and not collect_logits)
        if enable_prefix_cache and self._window is not None:
            print("[engine] sliding-window rolling release and prefix "
                  "caching don't compose; prefix cache disabled")
        if enable_prefix_cache and collect_logits:
            print("[engine] collect_logits needs every position's forward; "
                  "prefix cache disabled")
        self._prefix_cache: Dict[bytes, int] = {}  # prefix digest -> page
        self._page_refs: Dict[int, int] = {}       # shared page -> refs

        @functools.partial(jax.jit, donate_argnums=(1,))
        def _prefill_chunk_step(model, pools, x, table, base):
            return model.forward_extend_paged(x, pools, table, base)

        self._jit_prefill_chunk = _prefill_chunk_step
        self._jit_sample = jax.jit(_sample_tokens,
                                   static_argnames=("greedy_only",))
        # presence/reps ride as keyword arrays through the same jit

    # -- public API ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """KV positions per sequence (pages_per_seq * page_size)."""
        return self.pages_per_seq * self.page_size

    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_id: Optional[int] = None, temperature: float = 0.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               min_p: Optional[float] = None,
               seed: Optional[int] = None,
               repetition_penalty: Optional[float] = None,
               frequency_penalty: Optional[float] = None,
               presence_penalty: Optional[float] = None,
               stop: Optional[List[List[int]]] = None,
               on_token: Optional[Callable[[Request, List[int]], None]] = None,
               ) -> Request:
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if len(prompt) >= self.capacity:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds per-sequence KV "
                f"capacity {self.capacity} (pages_per_seq * page_size)")
        need = max(1, -(-len(prompt) // self.page_size))
        if need > self.pool.total:
            raise ValueError(
                f"prompt needs {need} pages but the pool only has "
                f"{self.pool.total}; request can never be admitted")
        req = Request(list(prompt), max_new_tokens, eos_id,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      min_p=min_p, seed=seed,
                      repetition_penalty=repetition_penalty,
                      frequency_penalty=frequency_penalty,
                      presence_penalty=presence_penalty,
                      stop=[list(s) for s in stop] if stop else None,
                      uid=self._uid, on_token=on_token)
        self._uid += 1
        self.queue.append(req)
        return req

    def cancel(self, req: Request) -> bool:
        """Cancel a request: a queued one is dropped, an active one is
        retired immediately (KV pages returned to the pool, partial
        ``generated`` kept).  Returns False if it already finished."""
        if req.done:
            return False
        req.cancelled = True
        if req in self.queue:
            self.queue.remove(req)
            req.done = True
            self.finished.append(req)
            return True
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request is req:
                self._retire(i)
                self._flush_stream(req)
                return True
        return False  # unknown request

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until every submitted request finishes; returns them."""
        for _ in range(max_steps):
            if not self.step():
                break
        return self.finished

    def stats(self) -> dict:
        """Observability snapshot: request/token counters, speculative
        acceptance rates and KV page-pool utilisation (the serving-side
        metrics surface; reference's training loop prints tokens/sec,
        run_machine_translation.py:232-237)."""
        out = {
            "finished_requests": len(self.finished),
            "active_requests": sum(s is not None for s in self.slots),
            "queued_requests": len(self.queue),
            "generated_tokens": sum(len(r.generated) for r in self.finished)
            + sum(len(s.request.generated) for s in self.slots
                  if s is not None),
            "pages_total": self.pool.total,
            "pages_free": self.pool.n_free,
            "prefix_cache_pages": len(self._prefix_cache),
        }
        if self.spec_stats[1]:
            out["spec_acceptance"] = self.spec_stats[0] / self.spec_stats[1]
            out["spec_waves"] = self.spec_stats[1]
        if self.lookup_stats[1]:
            out["lookup_acceptance"] = (self.lookup_stats[0]
                                        / self.lookup_stats[1])
            out["lookup_waves"] = self.lookup_stats[1]
        return out


    def _sampling_arrays(self):
        """(temps, topks, topps, minps, seeds, all_greedy): all_greedy is a
        host-side static flag that lets the jitted steps skip sampling
        entirely; seeds are per-REQUEST so sampled outputs don't depend on
        batch composition (see :func:`_row_keys`)."""
        temps = np.zeros((self.max_batch,), np.float32)
        topks = np.zeros((self.max_batch,), np.int32)
        topps = np.zeros((self.max_batch,), np.float32)
        minps = np.zeros((self.max_batch,), np.float32)
        seeds = np.zeros((self.max_batch,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot is not None:
                temps[i] = slot.request.temperature
                topks[i] = slot.request.top_k or 0
                topps[i] = slot.request.top_p or 0.0
                minps[i] = slot.request.min_p or 0.0
                seeds[i] = self._request_seed(slot.request)
        return (jnp.asarray(temps), jnp.asarray(topks), jnp.asarray(topps),
                jnp.asarray(minps), jnp.asarray(seeds), not temps.any())

    def _request_seed(self, req) -> int:
        """Per-request sampling seed: explicit ``submit(seed=...)`` wins,
        else derived from (engine seed, request uid) — deterministic across
        re-runs of the same submission order."""
        if req.seed is not None:
            return int(req.seed) & 0x7FFFFFFF
        return (self._seed * 1_000_003 + req.uid * 7919 + 17) & 0x7FFFFFFF

    def _penalty_arrays(self):
        """(reps, freqs, press, presence, pen_on): presence counts
        prompt+generated tokens per active row.  pen_on is a host-side
        static flag — when no active request carries any penalty, the
        jitted steps skip the (B, V) work entirely (presence collapses to
        a (B, 1) dummy)."""
        reps = np.ones((self.max_batch,), np.float32)
        freqs = np.zeros((self.max_batch,), np.float32)
        press = np.zeros((self.max_batch,), np.float32)
        pen_on = False
        for i, slot in enumerate(self.slots):
            if slot is not None:
                req = slot.request
                if req.repetition_penalty:
                    reps[i] = req.repetition_penalty
                freqs[i] = req.frequency_penalty or 0.0
                press[i] = req.presence_penalty or 0.0
                pen_on = (pen_on or reps[i] != 1.0 or freqs[i] != 0.0
                          or press[i] != 0.0)
        if not pen_on:
            return (jnp.asarray(reps), jnp.asarray(freqs), jnp.asarray(press),
                    jnp.zeros((self.max_batch, 1), jnp.float32), False)
        # per-slot presence vectors are maintained INCREMENTALLY (built from
        # the prompt at admit, new tokens folded in here), so per-step host
        # work is O(new tokens), not O(history)
        presence = np.zeros((self.max_batch, self.model.n_vocab), np.float32)
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.presence is not None:
                new = slot.request.generated[slot.presence_counted:]
                if new:
                    np.add.at(slot.presence, new, 1.0)
                    slot.presence_counted = len(slot.request.generated)
                presence[i] = slot.presence
        return (jnp.asarray(reps), jnp.asarray(freqs), jnp.asarray(press),
                jnp.asarray(presence), True)

    # -- scheduler ------------------------------------------------------------

    def _admit(self) -> List[int]:
        """Admit queued requests into free slots; allocate every page the
        prompt needs up front (batched prefill fills them in one dispatch).
        Returns the newly admitted slot ids."""
        admitted = []
        for i in range(self.max_batch):
            if self.slots[i] is not None or not self.queue:
                continue
            prompt = self.queue[0].prompt
            need = max(1, -(-len(prompt) // self.page_size))

            # prefix cache: attach the longest run of already-cached FULL
            # prompt pages (never the final token's page, so prefill always
            # has at least one position to produce seed logits from)
            shared: List[int] = []
            if self.enable_prefix_cache:
                max_cols = min((len(prompt) - 1) // self.page_size,
                               self.pages_per_seq - 1)
                for key in self._page_keys(prompt, max_cols):
                    page = self._prefix_cache.get(key)
                    if page is None:
                        break
                    shared.append(page)
                    # LRU touch: re-insert so hot prefixes evict last
                    self._prefix_cache[key] = self._prefix_cache.pop(key)
            own_need = need - len(shared)
            # the shared pages are about to be protected (ref bump), so
            # they must NOT count as evictable supply for this admission
            if (self.pool.n_free + self._evictable_pages(exclude=shared)
                    < own_need):
                break
            req = self.queue.pop(0)
            for p in shared:           # protect from eviction before alloc
                self._page_refs[p] += 1
            own = [self._alloc_page() for _ in range(own_need)]
            assert all(p is not None for p in own)  # guaranteed by the count
            pages = shared + own
            self.page_table[i, :need] = pages
            slot = _Slot(req, pages, length=0, next_input=req.prompt[0],
                         shared_pages=len(shared))
            if ((req.repetition_penalty and req.repetition_penalty != 1.0)
                    or req.frequency_penalty or req.presence_penalty):
                slot.presence = np.zeros((self.model.n_vocab,), np.float32)
                np.add.at(slot.presence, req.prompt, 1.0)
            self.slots[i] = slot
            admitted.append(i)
        return admitted

    def _prefill(self, admitted: List[int]) -> None:
        """One batched prefill dispatch for the newly admitted slots: every
        prompt position's K/V lands in its pages, the last position's logits
        seed generation.  Other slots' rows are idle (prompt_lens 0) and
        their writes routed to the trash page.  Prompts longer than
        ``prefill_chunk`` stream through the chunked path instead."""
        s_max = max(len(self.slots[i].request.prompt) for i in admitted)
        if (s_max > self.prefill_chunk
                or any(self.slots[i].shared_pages for i in admitted)):
            # cached-prefix skipping needs the per-row base offsets only
            # the chunked path has
            return self._prefill_chunked(admitted)
        s_pad = max(8, 1 << (s_max - 1).bit_length())  # pow2 buckets the jit
        s_pad = min(s_pad, self.capacity)

        tokens = np.zeros((self.max_batch, s_pad), np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        table = np.full_like(self.page_table, self._trash_page)
        for i in admitted:
            p = self.slots[i].request.prompt
            tokens[i, :len(p)] = p
            lens[i] = len(p)
            table[i] = self.page_table[i]

        temps, topks, topps, minps, seeds, greedy = self._sampling_arrays()
        reps, freqs, press, presence, pen_on = self._penalty_arrays()
        self.pools, sampled, lps, logits = self._jit_prefill(
            self.model, self.pools, jnp.asarray(tokens), jnp.asarray(table),
            jnp.asarray(lens), temps, topks, topps, minps, presence, reps,
            freqs, press, seeds, greedy=greedy, rep=pen_on)
        if self.draft_model is not None:
            # the draft's pools must hold the same history (same page ids)
            self.draft_pools, _, _, _ = self._jit_prefill(
                self.draft_model, self.draft_pools, jnp.asarray(tokens),
                jnp.asarray(table), jnp.asarray(lens), temps, topks, topps,
                minps, presence, reps, freqs, press, seeds,
                greedy=True, rep=False)
        sampled = np.asarray(sampled)
        if self.collect_logits:
            logits = np.asarray(logits)

        for i in admitted:
            req = self.slots[i].request
            if self.collect_logits:
                for t in range(len(req.prompt)):
                    req.logits.append(logits[i, t])
        self._seed_after_prefill(admitted, sampled, np.asarray(lps))

    def _register_prefix_pages(self, i: int) -> None:
        """Content-address this slot's FULL prompt pages so later requests
        with the same prefix can attach to them."""
        if not self.enable_prefix_cache:
            return
        slot = self.slots[i]
        prompt = slot.request.prompt
        ncols = min((len(prompt) - 1) // self.page_size,
                    self.pages_per_seq - 1)
        for j, key in enumerate(self._page_keys(prompt, ncols)):
            if key in self._prefix_cache:
                continue
            page = slot.pages[j]
            # the page gains two holders: the cache entry AND the owning
            # slot (which held it implicitly, outside the ref system)
            self._page_refs[page] = self._page_refs.get(page, 0) + 2
            self._prefix_cache[key] = page

    def _seed_after_prefill(self, admitted: List[int], sampled,
                            logprobs) -> None:
        """Shared prefill epilogue: record lengths, append the sampled seed
        token, and retire/allocate exactly like the decode epilogues."""
        for i in admitted:
            self._register_prefix_pages(i)
            slot = self.slots[i]
            req = slot.request
            slot.length = len(req.prompt)
            self._release_behind_window(i)
            tok = int(sampled[i])
            req.generated.append(tok)
            req.token_logprobs.append(float(logprobs[i]))
            slot.next_input = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if (len(req.generated) >= req.max_new_tokens or hit_eos
                    or slot.length >= self.capacity):
                self._retire(i)
            elif not self._ensure_pages(i, slot.length):
                req.truncated = True
                self._retire(i)

    def _prefill_chunked(self, admitted: List[int]) -> None:
        """Stream long prompts through fixed (B, prefill_chunk) extend
        waves.  Each wave consumes ``take = min(chunk, shortest remaining)``
        real tokens per unfinished row, so no unfinished row is ever padded
        mid-prompt; finished rows ride along with trash-routed tables."""
        c = self.prefill_chunk
        b = self.max_batch
        # cached prefix pages already hold their K/V — start past them
        consumed = {i: self.slots[i].shared_pages * self.page_size
                    for i in admitted}
        plen = {i: len(self.slots[i].request.prompt) for i in admitted}
        final_logits = np.zeros((b, self.model.n_vocab), np.float32)
        while True:
            unfinished = [i for i in admitted if consumed[i] < plen[i]]
            if not unfinished:
                break
            take = min(c, min(plen[i] - consumed[i] for i in unfinished))
            # pow2-bucket the wave width: a 24-token cache-hit suffix should
            # not pay a full prefill_chunk-wide dispatch (jit cache stays at
            # log2(chunk) entries)
            width = min(c, max(8, 1 << (take - 1).bit_length()))
            tokens = np.zeros((b, width), np.int32)
            base = np.zeros((b,), np.int32)
            table = np.full_like(self.page_table, self._trash_page)
            for i in unfinished:
                p = self.slots[i].request.prompt
                tokens[i, :take] = p[consumed[i]:consumed[i] + take]
                base[i] = consumed[i]
                table[i] = self.page_table[i]
            logits, self.pools = self._jit_prefill_chunk(
                self.model, self.pools, jnp.asarray(tokens),
                jnp.asarray(table), jnp.asarray(base))
            if self.draft_model is not None:
                _, self.draft_pools = self._jit_prefill_chunk(
                    self.draft_model, self.draft_pools, jnp.asarray(tokens),
                    jnp.asarray(table), jnp.asarray(base))
            logits = np.asarray(logits)
            for i in unfinished:
                req = self.slots[i].request
                if self.collect_logits:
                    for t in range(take):
                        req.logits.append(logits[i, t])
                consumed[i] += take
                if consumed[i] == plen[i]:
                    final_logits[i] = logits[i, take - 1]

        temps, topks, topps, minps, seeds, greedy = self._sampling_arrays()
        reps, freqs, press, presence, pen_on = self._penalty_arrays()
        pos = np.zeros((self.max_batch,), np.int32)
        for i in admitted:
            pos[i] = plen[i]
        sampled = np.asarray(self._jit_sample(
            jnp.asarray(final_logits), temps, topks, topps, seeds,
            jnp.asarray(pos),
            greedy_only=greedy, presence=presence if pen_on else None,
            reps=reps, minps=minps, freqs=freqs, press=press))
        shifted = final_logits - final_logits.max(-1, keepdims=True)
        lse = np.log(np.exp(shifted).sum(-1)) + final_logits.max(-1)
        lps = final_logits[np.arange(len(sampled)), sampled] - lse
        self._seed_after_prefill(admitted, sampled, lps)

    def _alloc_page(self) -> Optional[int]:
        """A free page, evicting the oldest cache-only prefix page if the
        pool is dry.  None when nothing can be freed."""
        if self.pool.n_free:
            return self.pool.alloc()
        for key, page in list(self._prefix_cache.items()):  # insertion order
            if self._page_refs.get(page, 0) == 1:      # cache-only
                del self._prefix_cache[key]
                del self._page_refs[page]
                return page
        return None

    def _evictable_pages(self, exclude=()) -> int:
        ex = set(exclude)
        return sum(1 for p in self._prefix_cache.values()
                   if self._page_refs.get(p, 0) == 1 and p not in ex)

    def _page_keys(self, prompt, ncols: int) -> List[bytes]:
        """Running-digest content keys for the first ``ncols`` FULL pages —
        O(page_size) per page instead of O(prefix) token tuples."""
        import hashlib

        h = hashlib.sha256()
        keys = []
        for j in range(ncols):
            page = prompt[j * self.page_size:(j + 1) * self.page_size]
            h.update(np.asarray(page, np.int64).tobytes())
            keys.append(h.digest())
        return keys

    def _drop_page_ref(self, page: int) -> None:
        """Detach one holder from a page; return it to the pool when no
        holder (slot or cache) remains."""
        if page in self._page_refs:
            self._page_refs[page] -= 1
            if self._page_refs[page] <= 0:
                del self._page_refs[page]
                self.pool.release([page])
        else:
            self.pool.release([page])

    def _ensure_pages(self, i: int, upto_pos: int) -> bool:
        """Allocate pages so the slot owns every table column up to the one
        holding ``upto_pos``; False (no change rolled back beyond what was
        already owned) if the pool runs dry."""
        slot = self.slots[i]
        need_cols = min(upto_pos // self.page_size + 1, self.pages_per_seq)
        while len(slot.pages) < need_cols:
            page = self._alloc_page()
            if page is None:
                return False
            slot.pages.append(page)
            self.page_table[i, len(slot.pages) - 1] = page
        return True

    def _release_behind_window(self, i: int) -> None:
        """Return pages wholly behind the sliding window to the pool."""
        if self._window is None:
            return
        slot = self.slots[i]
        first_needed = max(0, slot.length - self._window) // self.page_size
        freed = []
        for idx in range(min(first_needed, len(slot.pages))):
            if slot.pages[idx] is not None:
                freed.append(slot.pages[idx])
                slot.pages[idx] = None
                self.page_table[i, idx] = self._trash_page
        if freed:
            self.pool.release(freed)

    def _retire(self, i: int) -> None:
        slot = self.slots[i]
        slot.request.done = True
        self.finished.append(slot.request)
        for p in slot.pages:
            if p is not None:
                self._drop_page_ref(p)
        self.slots[i] = None
        # reset the WHOLE row: stale columns would route a later prefill's
        # padding-position scatters into pages owned by live requests
        self.page_table[i, :] = self._trash_page

    def _spec_ready(self, active: List[int]) -> bool:
        """Draft-model speculative wave allowed (see _wave_ready)."""
        if (self.draft_model is None or self.spec_len < 2
                or self.collect_logits):
            return False
        return self._wave_ready(active, self.spec_len, allow_sampling=True)

    def _wave_plausible(self, active: List[int]) -> bool:
        """Cheap static disqualifiers for a sampled/greedy lookup wave —
        checked BEFORE the O(history) proposal scan (no preallocation)."""
        if self.queue and any(s is None for s in self.slots):
            return False
        for i in active:
            req = self.slots[i].request
            if ((req.repetition_penalty and req.repetition_penalty != 1.0)
                    or req.frequency_penalty or req.presence_penalty):
                return False
            if req.temperature > 0 and (req.top_k or req.min_p
                                        or (req.top_p and req.top_p < 1.0)):
                return False
        return True

    def _wave_ready(self, active: List[int], width: int,
                    allow_sampling: bool = False) -> bool:
        """Speculative wave of ``width`` verify positions allowed: no
        pending admission and every active slot has room for the whole
        wave.  Greedy-only unless ``allow_sampling`` (the exact
        accept/residual wave handles plain temperature sampling; top-k/p,
        min-p and penalties reshape the distribution per step and always
        fall back).  On success, write room is PREALLOCATED."""
        if self.queue and any(s is None for s in self.slots):
            return False
        for i in active:
            slot = self.slots[i]
            req = slot.request
            if ((req.repetition_penalty and req.repetition_penalty != 1.0)
                    or req.frequency_penalty or req.presence_penalty):
                return False  # spec verification ignores penalties
            if req.temperature > 0 and not allow_sampling:
                return False
            if req.temperature > 0 and (req.top_k or req.min_p
                                        or (req.top_p and req.top_p < 1.0)):
                return False
            if slot.length + width > self.capacity:
                return False
        # all-or-nothing preallocation of write room for positions
        # length..length+width-1: COUNT first so a half-failed prealloc
        # can't strand pages one slot grabbed while another went dry (which
        # would later truncate requests a plain-greedy engine completes)
        need = 0
        for i in active:
            slot = self.slots[i]
            need_cols = min((slot.length + width - 1)
                            // self.page_size + 1, self.pages_per_seq)
            need += max(0, need_cols - len(slot.pages))
        if need > self.pool.n_free + self._evictable_pages():
            return False
        for i in active:
            ok = self._ensure_pages(i, self.slots[i].length + width - 1)
            assert ok  # guaranteed by the count above
        return True

    def _trim_pages(self, i: int) -> None:
        """Release trailing pages beyond the next write position (stranded
        speculative preallocation), so fallback paths see the same pool a
        draft-free engine would."""
        slot = self.slots[i]
        needed_cols = slot.length // self.page_size + 1
        while len(slot.pages) > needed_cols and slot.pages[-1] is not None:
            idx = len(slot.pages) - 1
            self._drop_page_ref(slot.pages.pop())
            self.page_table[i, idx] = self._trash_page

    def _run_spec(self, active, tokens, lengths) -> None:
        self.pools, self.draft_pools, drafts, greedy, lps = self._jit_spec(
            self.model, self.draft_model, self.pools, self.draft_pools,
            jnp.asarray(tokens), jnp.asarray(self.page_table),
            jnp.asarray(lengths), n_spec=self.spec_len)
        self._accept_wave(active, np.asarray(drafts), np.asarray(greedy),
                          np.asarray(lps), self.spec_len, self.spec_stats)

    def _spec_scan_waves(self, active) -> int:
        """How many greedy speculative waves can scan device-side before a
        host scheduling event, power-of-2 bucketed (mirrors
        _decode_chunk_len).  Each wave lands 1..spec_len tokens, so cap by
        the headroom a FULL-acceptance scan would consume — overshoot past
        EOS/max_new is discarded by the epilogue, undershoot just costs
        another dispatch."""
        w = self.spec_waves_per_dispatch
        if w <= 1 or self.collect_logits:
            return 1
        if self.queue and any(s is None for s in self.slots):
            return 1
        for i in active:
            slot = self.slots[i]
            req = slot.request
            headroom = min(req.max_new_tokens - len(req.generated),
                           self.capacity - slot.length)
            w = min(w, max(1, -(-headroom // self.spec_len)))
        # power-of-2 ladder: request tails step down 8->4->2->1 instead of
        # collapsing straight to single-wave.  Each distinct count is its
        # own compiled executable (log2 W of them) — a long-lived engine
        # compiles each once; benchmarks should warm a full request pass
        # before timing.
        return max(1, 1 << (max(w, 1).bit_length() - 1))

    def _run_spec_scan(self, active, tokens, lengths, n_waves) -> None:
        """Multi-wave greedy speculative decode: one dispatch runs
        ``n_waves`` x (draft scan + verify + device-side acceptance); the
        host lands each wave through the shared epilogue, dropping rows as
        they retire (their device-side continuation wrote only positions
        past the retained length — inert)."""
        (self.pools, self.draft_pools, toks, lps,
         n_land) = self._jit_spec_scan(
            self.model, self.draft_model, self.pools, self.draft_pools,
            jnp.asarray(tokens), jnp.asarray(self.page_table),
            jnp.asarray(lengths), n_spec=self.spec_len, n_waves=n_waves)
        toks = np.asarray(toks)                  # (W, B, n_spec)
        lps = np.asarray(lps)
        n_land = np.asarray(n_land)              # (W, B)
        live = list(active)
        for w in range(n_waves):
            if not live:
                break
            self._land_wave(live, {i: int(n_land[w, i]) for i in live},
                            toks[w], lps[w], self.spec_stats)
            live = [i for i in live if self.slots[i] is not None]

    def _resolve_ngram_impl(self):
        """Prefer the C++ proposer (native/ngram.cc — the per-wave context
        scan is the only O(history) host work in the decode loop); fall
        back to the pure-Python twin when the native lib can't build."""
        if self._ngram_impl is None:
            try:
                from ..utils.native_loader import ngram_propose_native
                ngram_propose_native([0, 0], 1)  # force build + load now
                self._ngram_impl = ngram_propose_native
            except Exception:
                self._ngram_impl = _ngram_propose
        return self._ngram_impl

    def _run_lookup(self, active, tokens, lengths, props) -> None:
        """Prompt-lookup wave: verify each row's n-gram proposal (padded
        with -1, which can never match a real token id) in one multi-token
        pass; rows with no proposal still land their plain greedy token."""
        k = self.prompt_lookup
        chunk = np.zeros((self.max_batch, k + 1), np.int32)
        drafts = np.full((self.max_batch, k), -1, np.int32)
        for i in active:
            chunk[i, 0] = tokens[i]
            p = props[i][:k]
            drafts[i, :len(p)] = p
            chunk[i, 1:1 + len(p)] = p
        self.pools, greedy, lps = self._jit_verify(
            self.model, self.pools, jnp.asarray(chunk),
            jnp.asarray(self.page_table), jnp.asarray(lengths))
        self._accept_wave(active, drafts, np.asarray(greedy),
                          np.asarray(lps), k + 1, self.lookup_stats)

    def _run_lookup_sampled(self, active, tokens, lengths, props) -> None:
        """Prompt-lookup wave under SAMPLING: device-side exact
        accept/residual (:func:`_spec_accept_sampled`) — the landed tokens
        are distributed exactly as plain per-token sampling, rows with
        temperature 0 take the argmax branch and stay token-identical."""
        k = self.prompt_lookup
        chunk = np.zeros((self.max_batch, k + 1), np.int32)
        for i in active:
            chunk[i, 0] = tokens[i]
            p = props[i][:k]
            chunk[i, 1:1 + len(p)] = p
        # proposals ride inside the chunk; pad positions are marked -1 via a
        # parallel matrix so the device never accepts them
        proposed = np.full((self.max_batch, k), -1, np.int32)
        for i in active:
            p = props[i][:k]
            proposed[i, :len(p)] = p
        temps = np.zeros((self.max_batch,), np.float32)
        seeds = np.zeros((self.max_batch,), np.int32)
        for i in active:
            temps[i] = self.slots[i].request.temperature
            seeds[i] = self._request_seed(self.slots[i].request)
        self.pools, n_acc, toks, lps = self._jit_verify_sampled(
            self.model, self.pools, jnp.asarray(chunk),
            jnp.asarray(proposed), jnp.asarray(self.page_table),
            jnp.asarray(lengths), jnp.asarray(temps), jnp.asarray(seeds))
        n_acc = np.asarray(n_acc)
        self._land_wave(active, {i: int(n_acc[i]) + 1 for i in active},
                        np.asarray(toks), np.asarray(lps),
                        self.lookup_stats)

    def _run_spec_sampled(self, active, tokens, lengths) -> None:
        """Draft-model wave under SAMPLING: the draft scan proposes its
        argmax chunk, the target verify applies the exact accept/residual
        rule device-side (see :func:`_spec_accept_sampled`)."""
        temps = np.zeros((self.max_batch,), np.float32)
        seeds = np.zeros((self.max_batch,), np.int32)
        for i in active:
            temps[i] = self.slots[i].request.temperature
            seeds[i] = self._request_seed(self.slots[i].request)
        (self.pools, self.draft_pools, n_acc, toks,
         lps) = self._jit_spec_sampled(
            self.model, self.draft_model, self.pools, self.draft_pools,
            jnp.asarray(tokens), jnp.asarray(self.page_table),
            jnp.asarray(lengths), jnp.asarray(temps), jnp.asarray(seeds),
            n_spec=self.spec_len)
        n_acc = np.asarray(n_acc)
        self._land_wave(active, {i: int(n_acc[i]) + 1 for i in active},
                        np.asarray(toks), np.asarray(lps), self.spec_stats)

    def _accept_wave(self, active, drafts, greedy, lps, width,
                     stats) -> None:
        """Greedy-acceptance epilogue for deterministic speculative waves.

        drafts (B, width-1) proposals; greedy (B, width) target argmaxes;
        lps (B, width) target logprobs.  Accept the proposal prefix the
        target agrees with, plus the target's own next token — exact greedy
        semantics."""
        n_land = {}
        for i in active:
            n = 1
            while n < width and drafts[i, n - 1] == greedy[i, n - 1]:
                n += 1
            n_land[i] = n
        self._land_wave(active, n_land, greedy, lps, stats)

    def _land_wave(self, active, n_land, toks, lps, stats) -> None:
        """Land ``n_land[i]`` tokens of ``toks[i]`` per row with the shared
        retire/window/page epilogue."""
        for i in active:
            slot = self.slots[i]
            req = slot.request
            stats[0] += n_land[i]
            stats[1] += 1
            retired = False
            for t in range(n_land[i]):
                tok = int(toks[i, t])
                slot.length += 1
                req.generated.append(tok)
                req.token_logprobs.append(float(lps[i, t]))
                slot.next_input = tok
                hit_eos = req.eos_id is not None and tok == req.eos_id
                if (len(req.generated) >= req.max_new_tokens or hit_eos
                        or slot.length >= self.capacity):
                    self._retire(i)
                    retired = True
                    break
            if not retired:
                self._release_behind_window(i)
                if not self._ensure_pages(i, slot.length):
                    req.truncated = True
                    self._retire(i)

    def _decode_chunk_len(self, active: List[int]) -> int:
        """How many pure-decode steps can run device-side before ANY host
        scheduling event (admission, page boundary, retirement-by-count)."""
        if self.collect_logits or self.steps_per_dispatch <= 1:
            return 1
        if self.queue and any(s is None for s in self.slots):
            return 1  # an admission is pending
        k = self.steps_per_dispatch
        for i in active:
            slot = self.slots[i]
            req = slot.request
            k = min(k,
                    req.max_new_tokens - len(req.generated),
                    self.page_size - (slot.length % self.page_size),
                    self.pages_per_seq * self.page_size - slot.length)
        # power of two keeps the jit cache to log2(steps_per_dispatch) entries
        return max(1, 1 << (max(k, 1).bit_length() - 1))

    def _run_chunk(self, active, tokens, lengths, n_steps) -> None:
        temps, topks, topps, minps, seeds, greedy = self._sampling_arrays()
        reps, freqs, press, presence, pen_on = self._penalty_arrays()
        self.pools, sampled, lps = self._jit_step_many(
            self.model, self.pools, jnp.asarray(tokens),
            jnp.asarray(self.page_table), jnp.asarray(lengths),
            temps, topks, topps, minps, presence, reps, freqs, press,
            seeds, n_steps=n_steps, greedy=greedy, rep=pen_on)
        sampled = np.asarray(sampled)                  # (K, B)
        lps = np.asarray(lps)
        for i in active:
            slot = self.slots[i]
            req = slot.request
            slot.length += n_steps
            self._release_behind_window(i)
            slot.next_input = int(sampled[-1, i])
            for t in range(n_steps):
                tok = int(sampled[t, i])
                req.generated.append(tok)
                req.token_logprobs.append(float(lps[t, i]))
                if req.eos_id is not None and tok == req.eos_id:
                    # tokens sampled after EOS inside the chunk are discarded
                    self._retire(i)
                    break
            else:
                if (len(req.generated) >= req.max_new_tokens
                        or slot.length >= self.capacity):
                    self._retire(i)
                elif not self._ensure_pages(i, slot.length):
                    # next write position needs a page the pool can't supply
                    req.truncated = True
                    self._retire(i)

    def step(self) -> bool:
        """One engine iteration: admit (+ batched prefill), decode one token
        per active slot, advance/retire.  Returns False when idle.

        Streaming epilogue: after the iteration's work, every request that
        gained tokens has them delivered through its ``on_token`` callback
        (live slots and requests that finished this step alike)."""
        # honor cancelled flags set directly on requests between steps
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request.cancelled:
                self._retire(i)
        for r in self.queue:
            if r.cancelled:  # never ran: mark finished so callers unblock
                r.done = True
                self.finished.append(r)
        self.queue = [r for r in self.queue if not r.cancelled]
        pre_finished = len(self.finished)
        progressed = self._step_inner()
        # stop sequences: trim at the earliest match, then retire
        for i, slot in enumerate(self.slots):
            if slot is not None and _apply_stop(slot.request):
                self._retire(i)
        for req in self.finished[pre_finished:]:
            _apply_stop(req)
        for slot in self.slots:
            if slot is not None:
                self._flush_stream(slot.request)
        for req in self.finished[pre_finished:]:
            self._flush_stream(req)
        return progressed

    @staticmethod
    def _flush_stream(req: Request) -> None:
        if req.on_token is not None and len(req.generated) > req._streamed:
            new = req.generated[req._streamed:]
            req._streamed = len(req.generated)
            req.on_token(req, new)

    def _step_inner(self) -> bool:
        admitted = self._admit()
        if admitted:
            self._prefill(admitted)
            return True
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return bool(self.queue)

        tokens = np.zeros((self.max_batch,), np.int32)
        lengths = np.zeros((self.max_batch,), np.int32)
        for i in active:
            tokens[i] = self.slots[i].next_input
            lengths[i] = self.slots[i].length

        if self.draft_model is not None:
            all_greedy = all(self.slots[i].request.temperature == 0
                             for i in active)
            if (all_greedy and self.spec_len >= 2
                    and not self.collect_logits):
                # multi-wave device-side scan: widest wave count whose
                # pages preallocate, halving down the pow-2 ladder on pool
                # pressure
                w = self._spec_scan_waves(active)
                while w > 1 and not self._wave_ready(
                        active, w * self.spec_len):
                    w //= 2
                if w > 1:
                    self._run_spec_scan(active, tokens, lengths, w)
                    return True
            if self._spec_ready(active):
                if all_greedy:
                    self._run_spec(active, tokens, lengths)
                else:
                    self._run_spec_sampled(active, tokens, lengths)
                return True
            for i in active:   # return any stranded speculative prealloc
                self._trim_pages(i)
        elif self.prompt_lookup and not self.collect_logits:
            # _wave_plausible first: the O(history) proposal scans must not
            # run every step for batches that can never take a wave (a
            # penalty/top-k row or pending admission disqualifies globally)
            props = None
            if self._wave_plausible(active):
                propose = self._resolve_ngram_impl()
                props = {i: propose(
                    self.slots[i].request.prompt
                    + self.slots[i].request.generated,
                    self.prompt_lookup, self.lookup_max_ngram)
                    for i in active}
            if (props and any(props.values())
                    and self._wave_ready(active, self.prompt_lookup + 1,
                                         allow_sampling=True)):
                all_greedy = all(
                    self.slots[i].request.temperature == 0 for i in active)
                if all_greedy:
                    self._run_lookup(active, tokens, lengths, props)
                else:
                    self._run_lookup_sampled(active, tokens, lengths, props)
                return True
            for i in active:   # return any stranded speculative prealloc
                self._trim_pages(i)

        n_steps = self._decode_chunk_len(active)
        if n_steps > 1:
            self._run_chunk(active, tokens, lengths, n_steps)
            return True

        temps, topks, topps, minps, seeds, greedy = self._sampling_arrays()
        reps, freqs, press, presence, pen_on = self._penalty_arrays()
        self.pools, sampled, lps, step_logits = self._jit_step(
            self.model, self.pools, jnp.asarray(tokens),
            jnp.asarray(self.page_table), jnp.asarray(lengths),
            temps, topks, topps, minps, presence, reps, freqs, press,
            seeds, greedy=greedy, rep=pen_on)
        sampled = np.asarray(sampled)
        lps = np.asarray(lps)
        if self.collect_logits:
            step_logits = np.asarray(step_logits)
            for i in active:
                self.slots[i].request.logits.append(step_logits[i])

        for i in active:
            slot = self.slots[i]
            req = slot.request
            slot.length += 1
            self._release_behind_window(i)
            tok = int(sampled[i])
            req.generated.append(tok)
            req.token_logprobs.append(float(lps[i]))
            slot.next_input = tok
            # Same epilogue order as _run_chunk: the sampled token is always
            # kept, normal retirement (count/EOS/capacity) is checked BEFORE
            # just-in-time page allocation, and only a request that actually
            # needs another page can be truncated by pool exhaustion.
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if (len(req.generated) >= req.max_new_tokens or hit_eos
                    or slot.length >= self.capacity):
                self._retire(i)
            elif not self._ensure_pages(i, slot.length):
                req.truncated = True
                self._retire(i)
        return True
