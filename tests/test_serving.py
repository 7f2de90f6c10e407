"""Continuous-batching engine vs dense-context decoding.

The engine (paged KV pools, mid-flight admission, page reuse) must compute
the SAME next-token logits the plain full-context forward computes at every
position.  Logits comparison is teacher-forced (the full token trajectory is
submitted as the prompt), which avoids greedy-argmax tie flips on a
random-init model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import flashattn_tpu as ft
from flashattn_tpu.serving import ContinuousBatchingEngine


@pytest.fixture(scope="module")
def model():
    return ft.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                        attn_impl="flash", key=jax.random.PRNGKey(0)).eval()


def _dense_logits(model, tokens):
    """(T, vocab) next-token logits from one full-context forward."""
    return np.asarray(model(jnp.asarray([tokens], jnp.int32))[0])


def _assert_engine_matches_dense(model, trajectories, max_batch, page_size,
                                 pages_per_seq):
    eng = ContinuousBatchingEngine(model, max_batch=max_batch,
                                   page_size=page_size,
                                   pages_per_seq=pages_per_seq,
                                   collect_logits=True)
    reqs = [eng.submit(t, 1) for t in trajectories]
    eng.run()
    assert all(r.done for r in reqs)
    assert eng.pool.n_free == eng.pool.total  # every page returned
    for t, r in zip(trajectories, reqs):
        got = np.stack(r.logits)              # (T, vocab): logits per position
        want = _dense_logits(model, t)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_engine_matches_dense_logits(model):
    trajectories = [[1, 5, 9, 11, 2], [2, 8], [3, 3, 3, 3, 3, 7, 50, 1]]
    _assert_engine_matches_dense(model, trajectories, max_batch=4,
                                 page_size=16, pages_per_seq=4)


def test_engine_midflight_admission_and_slot_reuse(model):
    """More requests than slots: later requests admitted as earlier retire,
    reusing freed pages — logits must stay exact."""
    rng = np.random.default_rng(0)
    trajectories = [list(rng.integers(1, 60, size=6 + i)) for i in range(5)]
    _assert_engine_matches_dense(model, trajectories, max_batch=2,
                                 page_size=16, pages_per_seq=3)


def test_engine_page_boundary_crossing(model):
    """Trajectory spanning several pages (page_size 8, 4 pages)."""
    rng = np.random.default_rng(1)
    trajectories = [list(rng.integers(1, 60, size=27))]
    _assert_engine_matches_dense(model, trajectories, max_batch=1,
                                 page_size=8, pages_per_seq=4)


def test_engine_greedy_generation(model):
    """End-to-end greedy generation matches the dense loop (short horizon to
    stay clear of argmax near-ties on a random-init model)."""
    prompt, n_new = [1, 5, 9], 4

    toks = list(prompt)
    for _ in range(n_new):
        logits = model(jnp.asarray([toks], jnp.int32))
        toks.append(int(jnp.argmax(logits[0, -1])))
    want = toks[len(prompt):]

    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=16,
                                   pages_per_seq=4)
    r = eng.submit(prompt, n_new)
    eng.run()
    assert r.generated == want


def test_engine_eos_stops(model):
    logits = model(jnp.asarray([[4, 2]], jnp.int32))
    first = int(jnp.argmax(logits[0, -1]))
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=16,
                                   pages_per_seq=3)
    r = eng.submit([4, 2], 10, eos_id=first)
    eng.run()
    assert r.generated == [first]


def test_chunked_decode_matches_single_step(model):
    """steps_per_dispatch=8 (device-side scan chunks) must produce exactly
    the tokens of steps_per_dispatch=1, including EOS truncation mid-chunk
    and page-boundary crossings at chunk edges."""
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(1, 60, size=3)) for _ in range(3)]

    def run(spd):
        eng = ContinuousBatchingEngine(model, max_batch=4, page_size=8,
                                       pages_per_seq=4,
                                       steps_per_dispatch=spd)
        reqs = [eng.submit(p, 21) for p in prompts]
        # one request with an eos likely to fire mid-chunk
        logits = model(jnp.asarray([prompts[0]], jnp.int32))
        seq = list(prompts[0])
        for _ in range(5):
            seq.append(int(jnp.argmax(model(
                jnp.asarray([seq], jnp.int32))[0, -1])))
        eos = seq[len(prompts[0]) + 4]  # 5th generated token
        reqs.append(eng.submit(prompts[0], 21, eos_id=eos))
        eng.run()
        assert eng.pool.n_free == eng.pool.total
        return [r.generated for r in reqs]

    assert run(8) == run(1)


def test_submit_rejects_oversized_prompt(model):
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=8,
                                   pages_per_seq=2)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(list(range(1, 17)), 4)   # 16 tokens == capacity
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit([], 4)


def test_generation_to_exact_capacity(model):
    """A sequence can fill every KV position: prompt 2 + 14 generated on a
    16-slot cache (off-by-one here truncated the final token)."""
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=8,
                                   pages_per_seq=2, steps_per_dispatch=1)
    r = eng.submit([7, 9], 14)
    eng.run()
    assert len(r.generated) == 14 and not r.truncated


def test_pool_exhaustion_truncates_gracefully(model):
    """Over-committed pool: a sequence crossing a page boundary with no free
    pages is truncated (flagged), never corrupting other requests."""
    # 2 slots x up to 3 pages each, but only 4 physical pages
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=8,
                                   pages_per_seq=3, total_pages=4,
                                   steps_per_dispatch=1,
                                   collect_logits=True)
    rng = np.random.default_rng(3)
    tra = [list(rng.integers(1, 60, size=2)) for _ in range(2)]
    reqs = [eng.submit(t, 20) for t in tra]
    eng.run()
    assert all(r.done for r in reqs)
    assert any(r.truncated for r in reqs)
    assert eng.pool.n_free == eng.pool.total
    # the non-truncated request's logits still match dense exactly
    survivors = [(t, r) for t, r in zip(tra, reqs) if not r.truncated]
    for t, r in survivors:
        full = t + r.generated
        want = _dense_logits(model, full[:len(r.logits)])
        np.testing.assert_allclose(np.stack(r.logits), want,
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_engine_quantized_kv_pages(model, kv_dtype):
    """INT8/FP8 paged KV inside the engine (BASELINE configs[3]): logits
    track the dense forward within quantisation noise."""
    dtype = jnp.int8 if kv_dtype == "int8" else jnp.float8_e4m3fn
    rng = np.random.default_rng(4)
    trajectories = [list(rng.integers(1, 60, size=10)) for _ in range(2)]
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=16,
                                   pages_per_seq=3, dtype=dtype,
                                   collect_logits=True)
    reqs = [eng.submit(t, 1) for t in trajectories]
    eng.run()
    for t, r in zip(trajectories, reqs):
        got = np.stack(r.logits)
        want = _dense_logits(model, t)
        rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert rel < 0.08, rel  # int8/fp8 KV noise, not kernel error
        # greedy argmax still overwhelmingly agrees
        agree = np.mean(np.argmax(got, -1) == np.argmax(want, -1))
        assert agree >= 0.8, agree


def test_engine_tp_sharded(model):
    """TP-sharded serving (mesh over heads): logits identical to the
    unsharded engine / dense forward."""
    from flashattn_tpu.parallel import create_mesh

    mesh = create_mesh((4,), ("model",))
    rng = np.random.default_rng(5)
    trajectories = [list(rng.integers(1, 60, size=7)) for _ in range(2)]
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=16,
                                   pages_per_seq=3, mesh=mesh,
                                   collect_logits=True)
    reqs = [eng.submit(t, 1) for t in trajectories]
    eng.run()
    for t, r in zip(trajectories, reqs):
        got = np.stack(r.logits)
        want = _dense_logits(model, t)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_slot_reuse_with_shrinking_prompt(model):
    """Regression (review): a retired slot's stale page-table columns must
    not route a later prefill's padding positions into live pages."""
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=4,
                                   pages_per_seq=4, collect_logits=True)
    rng = np.random.default_rng(6)
    long_p = list(rng.integers(1, 60, size=13))   # 4 pages
    eng.submit(long_p, 2)
    eng.run()
    short_p = list(rng.integers(1, 60, size=9))   # 3 pages; s_pad 16 > 12
    r = eng.submit(short_p, 5)
    eng.run()
    # teacher-force compare decode logits against dense
    full = short_p + r.generated
    want = _dense_logits(model, full)[len(short_p) - 1:len(full) - 1]
    got = np.stack(r.logits)[len(short_p) - 1:]
    np.testing.assert_allclose(got[:len(want)], want, atol=1e-4, rtol=1e-4)


def test_submit_rejects_pool_impossible_prompt(model):
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=4,
                                   pages_per_seq=8, total_pages=2)
    with pytest.raises(ValueError, match="never be admitted"):
        eng.submit(list(range(1, 10)), 4)  # needs 3 pages, pool has 2


def test_adamw_with_schedule():
    from flashattn_tpu.optim import AdamW, warmup_cosine

    opt = AdamW(lr=warmup_cosine(0.01, 5, 50), weight_decay=0.01)
    m = {"w": jnp.ones((3,))}
    s = opt.init(m)
    m, s = opt.step(m, {"w": jnp.ones((3,))}, s)
    assert bool(jnp.all(jnp.isfinite(m["w"])))


def test_sampling_temperature_and_topk(model):
    """temperature=0 stays greedy; temperature>0 is seed-deterministic and
    top_k restricts candidates to the per-step top-k set."""
    prompt = [3, 9, 27]

    def run(seed, **kw):
        eng = ContinuousBatchingEngine(model, max_batch=2, page_size=16,
                                       pages_per_seq=4, seed=seed,
                                       collect_logits=True)
        r = eng.submit(prompt, 10, **kw)
        eng.run()
        return r

    g1, g2 = run(0), run(1)
    assert g1.generated == g2.generated  # greedy ignores the seed

    s1, s2 = run(0, temperature=1.5), run(0, temperature=1.5)
    assert s1.generated == s2.generated  # same seed -> deterministic
    s3 = run(7, temperature=1.5)
    assert s3.generated != s1.generated  # different seed diverges (w.h.p.)

    k = 3
    r = run(0, temperature=1.5, top_k=k)
    for logits_row, tok in zip(r.logits[len(prompt) - 1:], r.generated):
        topk = np.argsort(logits_row)[::-1][:k]
        assert tok in topk, (tok, topk)


def test_reference_model_serves_through_the_gather():
    """attn_impl="reference" takes the XLA gather for paged decode and the
    op graph for prefill; its engine logits equal the kernel route's."""
    import flashattn_tpu as ft

    logits = []
    for impl in ("flash", "reference"):
        model = ft.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                             n_kv_head=2, attn_impl=impl,
                             key=jax.random.PRNGKey(4)).eval()
        eng = ContinuousBatchingEngine(model, max_batch=2, page_size=4,
                                       pages_per_seq=8, collect_logits=True,
                                       prefill_chunk=8)
        reqs = [eng.submit([3, 9, 1, 4, 4, 7, 2, 8, 5, 6, 1], 5),
                eng.submit([2, 7, 1], 7)]
        eng.run()
        logits.append([np.stack(r.logits) for r in reqs])
    for a, b in zip(*logits):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)


class TestChunkedPrefill:
    """Long prompts stream through fixed-size extend waves; results must be
    indistinguishable from the single-dispatch prefill."""

    def _model(self, window=None):
        import flashattn_tpu as ft

        return ft.DecoderLM(64, 32, 4, 512, p_dropout=0.0, n_layer=2,
                            window=window, attn_impl="flash",
                            key=jax.random.PRNGKey(0)).eval()

    def test_matches_dense_forward(self):
        model = self._model()
        eng = ContinuousBatchingEngine(model, max_batch=2, page_size=4,
                                       pages_per_seq=16, collect_logits=True,
                                       prefill_chunk=8)
        rng = np.random.default_rng(0)
        reqs = [eng.submit(list(rng.integers(1, 60, 29)), 6),
                eng.submit(list(rng.integers(1, 60, 13)), 9)]
        eng.run()
        for r in reqs:
            full = r.prompt + r.generated
            want = np.asarray(model(jnp.asarray([full[:len(r.logits)]],
                                                jnp.int32))[0])
            np.testing.assert_allclose(np.stack(r.logits), want,
                                       atol=2e-4, rtol=2e-4)

    def test_equals_unchunked_engine(self):
        model = self._model()
        rng = np.random.default_rng(1)
        prompts = [list(rng.integers(1, 60, n)) for n in (40, 7, 23)]

        def run(chunk):
            eng = ContinuousBatchingEngine(model, max_batch=3, page_size=8,
                                           pages_per_seq=8,
                                           prefill_chunk=chunk)
            reqs = [eng.submit(p, 12) for p in prompts]
            eng.run()
            return [r.generated for r in reqs]

        assert run(1024) == run(8)

    def test_near_capacity_prompt(self):
        """Final wave's padding positions overflow capacity: the clamped
        scatter must not corrupt the real pages."""
        model = self._model()
        eng = ContinuousBatchingEngine(model, max_batch=1, page_size=4,
                                       pages_per_seq=8, collect_logits=True,
                                       prefill_chunk=16)
        prompt = list(np.random.default_rng(2).integers(1, 60, 30))  # cap 32
        r = eng.submit(prompt, 2)
        eng.run()
        full = r.prompt + r.generated
        want = np.asarray(model(jnp.asarray([full[:len(r.logits)]],
                                            jnp.int32))[0])
        np.testing.assert_allclose(np.stack(r.logits), want,
                                   atol=2e-4, rtol=2e-4)

    def test_final_wave_past_position_table(self):
        """A model whose position table ends at the pool's capacity: the
        final wave's padding runs past both, and its embedding lookups must
        stay finite, or the NaN keys and values it writes poison every later
        read of that page."""
        import flashattn_tpu as ft

        model = ft.DecoderLM(64, 32, 4, 32, p_dropout=0.0, n_layer=2,
                             attn_impl="flash",
                             key=jax.random.PRNGKey(0)).eval()
        eng = ContinuousBatchingEngine(model, max_batch=2, page_size=4,
                                       pages_per_seq=8, collect_logits=True,
                                       prefill_chunk=16)
        rng = np.random.default_rng(7)
        reqs = [eng.submit(list(rng.integers(1, 60, 3)), 2),
                eng.submit(list(rng.integers(1, 60, 28)), 2)]
        eng.run()
        for r in reqs:
            full = r.prompt + r.generated
            want = np.asarray(model(jnp.asarray([full[:len(r.logits)]],
                                                jnp.int32))[0])
            np.testing.assert_allclose(np.stack(r.logits), want,
                                       atol=2e-4, rtol=2e-4)

    def test_uneven_waves_overflow_capacity(self):
        """Mixed prompt lengths make a final wave whose base + width pushes
        positions AND the attention length past capacity — the scatter
        clamp and the kernels' page-walk clamp must both hold."""
        model = self._model()
        rng = np.random.default_rng(7)
        prompts = [list(rng.integers(1, 60, 3)),
                   list(rng.integers(1, 60, 30))]   # cap = 32

        def run(chunk):
            eng = ContinuousBatchingEngine(model, max_batch=2, page_size=4,
                                           pages_per_seq=8,
                                           prefill_chunk=chunk)
            reqs = [eng.submit(p, 2) for p in prompts]
            eng.run()
            return [r.generated for r in reqs]

        # chunk 16: waves take 3 then 16 then 11 -> base 19 + width 16 > 32
        assert run(1024) == run(16)

    def test_windowed_chunked_prefill(self):
        model = self._model(window=8)
        rng = np.random.default_rng(3)
        prompts = [list(rng.integers(1, 60, 25))]

        def run(chunk):
            eng = ContinuousBatchingEngine(model, max_batch=1, page_size=4,
                                           pages_per_seq=16,
                                           prefill_chunk=chunk)
            reqs = [eng.submit(p, 10) for p in prompts]
            eng.run()
            return [r.generated for r in reqs]

        assert run(1024) == run(8)


def test_streaming_callback_delivers_all_tokens_in_order(model):
    """on_token must stream exactly the generated sequence, in order, in
    per-dispatch batches (chunked decode delivers several at once)."""
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=16,
                                   pages_per_seq=4, steps_per_dispatch=4)
    streamed = {}

    def on_token(req, new):
        assert new, "callback must never fire empty"
        streamed.setdefault(req.uid, []).extend(new)

    reqs = [eng.submit([1, 2, 3], 12, on_token=on_token),
            eng.submit([4, 5], 7, on_token=on_token)]
    eng.run()
    for r in reqs:
        assert r.done
        assert streamed[r.uid] == r.generated
        assert len(r.generated) == r.max_new_tokens


def test_cancel_queued_and_active(model):
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                   pages_per_seq=4, steps_per_dispatch=1)
    active = eng.submit([1, 2, 3], 50)
    queued = eng.submit([4, 5, 6], 50)
    # admit + prefill the first request, decode a couple of tokens
    for _ in range(3):
        eng.step()
    assert not active.done and len(active.generated) >= 1
    # cancel the queued one: dropped without ever running
    assert eng.cancel(queued)
    assert queued.done and queued.cancelled and queued.generated == []
    # cancel the active one: retired immediately, pages back in the pool
    partial = list(active.generated)
    assert eng.cancel(active)
    assert active.done and active.cancelled
    assert active.generated == partial
    assert eng.pool.n_free == eng.pool.total
    assert not eng.step()  # engine idle
    assert eng.cancel(active) is False  # double-cancel is a no-op


def test_cancel_flag_honored_between_steps(model):
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                   pages_per_seq=4, steps_per_dispatch=1)
    req = eng.submit([1, 2, 3], 50)
    eng.step()  # admit + prefill
    req.cancelled = True  # set directly, no engine call
    eng.step()
    assert req.done and eng.pool.n_free == eng.pool.total


def test_sample_tokens_top_p_nucleus():
    """Unit-test the sampler: tiny top_p collapses to greedy; top_p
    restricts support to the nucleus; disabled rows are unaffected."""
    from flashattn_tpu.serving.engine import _sample_tokens

    logits = jnp.asarray([
        [5.0, 4.9, 0.0, -1.0, -2.0],   # two dominant tokens
        [5.0, 4.9, 0.0, -1.0, -2.0],
        [5.0, 4.9, 0.0, -1.0, -2.0],
    ])
    temps = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)
    topks = jnp.zeros((3,), jnp.int32)
    # row0: p=1e-4 -> nucleus is exactly the argmax; row1: p=0 -> off;
    # row2: p=0.95 -> top two tokens only (their mass > 0.97)
    topps = jnp.asarray([1e-4, 0.0, 0.95], jnp.float32)
    counts = np.zeros((3, 5), np.int64)
    for s in range(200):
        toks = np.asarray(_sample_tokens(
            logits, temps, topks, topps, jnp.zeros((3,), jnp.int32),
            jnp.full((3,), s, jnp.int32)))
        for r in range(3):
            counts[r, toks[r]] += 1
    assert counts[0, 0] == 200                 # collapsed to greedy
    assert counts[1, 2:].sum() > 0 or counts[1, 1] > 0  # unrestricted row varies
    assert counts[2, 2:].sum() == 0            # nucleus excludes the tail
    assert counts[2, 1] > 0                    # but keeps the runner-up


def test_stop_sequences(model):
    """Generation ends at the earliest stop-sequence match (match kept);
    outputs are a prefix of the unconstrained greedy generation."""
    eng0 = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                    pages_per_seq=4, steps_per_dispatch=4)
    free = eng0.submit([1, 2, 3], 20)
    eng0.run()
    full = list(free.generated)
    assert len(full) == 20
    # stop at the 5th token's value: generation must end exactly there
    stop_tok = full[4]
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                   pages_per_seq=4, steps_per_dispatch=4)
    req = eng.submit([1, 2, 3], 20, stop=[[stop_tok]])
    eng.run()
    assert req.done
    first = full.index(stop_tok)
    assert req.generated == full[:first + 1]
    assert eng.pool.n_free == eng.pool.total
    # multi-token stop: the pair (full[2], full[3])
    eng2 = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                    pages_per_seq=4, steps_per_dispatch=4)
    req2 = eng2.submit([1, 2, 3], 20, stop=[[full[2], full[3]]])
    eng2.run()
    assert req2.generated == full[:4]
    # streaming never delivers past the trim
    eng3 = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                    pages_per_seq=4, steps_per_dispatch=4)
    streamed = []
    req3 = eng3.submit([1, 2, 3], 20, stop=[[stop_tok]],
                       on_token=lambda r, new: streamed.extend(new))
    eng3.run()
    assert streamed == req3.generated == full[:first + 1]


def test_repetition_penalty_matches_dense_reference(model):
    """Greedy + repetition penalty through the engine (incl. the chunked
    path's device-side presence carry) must equal a host-side dense loop
    applying the HF rule at every step."""
    prompt = [5, 9, 2]
    n_new = 12
    pen = 1.5
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                   pages_per_seq=4, steps_per_dispatch=4)
    req = eng.submit(prompt, n_new, repetition_penalty=pen)
    eng.run()

    seen = np.zeros((64,), np.float32)
    for t in prompt:
        seen[t] += 1
    toks = list(prompt)
    expect = []
    for _ in range(n_new):
        logits = _dense_logits(model, toks)[-1].astype(np.float64)
        adj = np.where(logits > 0, logits / pen, logits * pen)
        logits = np.where(seen > 0, adj, logits)
        nxt = int(np.argmax(logits))
        expect.append(nxt)
        toks.append(nxt)
        seen[nxt] += 1
    assert req.generated == expect
    # sanity: the penalty actually changed the output vs plain greedy
    eng2 = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                    pages_per_seq=4, steps_per_dispatch=4)
    plain = eng2.submit(prompt, n_new)
    eng2.run()
    assert plain.generated != expect


def test_sample_tokens_top_k_top_p_sequential():
    """top_p composes with top_k sequentially (HF/vLLM): the nucleus is
    computed over the RENORMALISED top-k survivors, so a token inside the
    raw-distribution nucleus but outside the renormalised one is excluded."""
    from flashattn_tpu.serving.engine import _sample_tokens

    # softmax ~ [0.50, 0.20, 0.15, 0.15] scaled: top-2 renormalise to
    # [0.714, 0.286]; top_p=0.6 keeps ONLY token 0 (raw nucleus keeps 2)
    logits = jnp.log(jnp.asarray([[0.50, 0.20, 0.15, 0.15]]))
    temps = jnp.asarray([1.0], jnp.float32)
    topks = jnp.asarray([2], jnp.int32)
    topps = jnp.asarray([0.6], jnp.float32)
    for s in range(100):
        tok = int(_sample_tokens(logits, temps, topks, topps,
                                 jnp.zeros((1,), jnp.int32),
                                 jnp.full((1,), s, jnp.int32))[0])
        assert tok == 0, tok


def test_sample_tokens_min_p():
    """min-p keeps only tokens with p >= min_p * p_max (temperature-scaled);
    min_p=0 leaves the distribution unrestricted."""
    from flashattn_tpu.serving.engine import _sample_tokens

    # probs [0.5, 0.3, 0.15, 0.05]: min_p=0.5 keeps {0, 1} (0.3 >= 0.25),
    # excludes 2 (0.15 < 0.25)
    logits = jnp.log(jnp.asarray([[0.5, 0.3, 0.15, 0.05],
                                  [0.5, 0.3, 0.15, 0.05]]))
    temps = jnp.ones((2,), jnp.float32)
    topks = jnp.zeros((2,), jnp.int32)
    topps = jnp.zeros((2,), jnp.float32)
    minps = jnp.asarray([0.5, 0.0], jnp.float32)
    seen = [set(), set()]
    for s in range(300):
        toks = np.asarray(_sample_tokens(
            logits, temps, topks, topps, jnp.zeros((2,), jnp.int32),
            jnp.full((2,), s, jnp.int32), minps=minps))
        seen[0].add(int(toks[0]))
        seen[1].add(int(toks[1]))
    assert seen[0] == {0, 1}, seen[0]
    assert len(seen[1]) >= 3  # unrestricted row explores the tail


def test_frequency_presence_penalty_matches_dense_reference(model):
    """Greedy + OpenAI-style frequency/presence penalties through the
    engine (incl. the chunked path's device-side presence carry) must
    equal a host-side dense loop applying logits -= f*count + p*(count>0)
    at every step."""
    prompt = [5, 9, 2]
    n_new = 12
    f_pen, p_pen = 0.8, 0.6
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                   pages_per_seq=4, steps_per_dispatch=4)
    req = eng.submit(prompt, n_new, frequency_penalty=f_pen,
                     presence_penalty=p_pen)
    eng.run()

    seen = np.zeros((64,), np.float32)
    for t in prompt:
        seen[t] += 1
    toks = list(prompt)
    expect = []
    for _ in range(n_new):
        logits = _dense_logits(model, toks)[-1].astype(np.float64)
        logits = logits - f_pen * seen - p_pen * (seen > 0)
        nxt = int(np.argmax(logits))
        expect.append(nxt)
        toks.append(nxt)
        seen[nxt] += 1
    assert req.generated == expect
    # sanity: the penalties actually changed the output vs plain greedy
    eng2 = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                    pages_per_seq=4, steps_per_dispatch=4)
    plain = eng2.submit(prompt, n_new)
    eng2.run()
    assert plain.generated != expect


def test_sample_tokens_frequency_presence_unit():
    """Unit check of the additive rule: token 0 dominates but carries a
    presence count; with a large penalty the argmax moves to token 1,
    and a zero-penalty row is untouched."""
    from flashattn_tpu.serving.engine import _sample_tokens

    logits = jnp.asarray([[3.0, 2.5, 0.0], [3.0, 2.5, 0.0]])
    presence = jnp.asarray([[2.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    temps = jnp.zeros((2,), jnp.float32)           # greedy
    topks = jnp.zeros((2,), jnp.int32)
    topps = jnp.zeros((2,), jnp.float32)
    reps = jnp.ones((2,), jnp.float32)             # HF rule off
    freqs = jnp.asarray([0.2, 0.0], jnp.float32)   # row0: 3.0-0.4-0.3=2.3
    press = jnp.asarray([0.3, 0.0], jnp.float32)
    toks = np.asarray(_sample_tokens(
        logits, temps, topks, topps, jnp.zeros((2,), jnp.int32),
        jnp.zeros((2,), jnp.int32),
        greedy_only=True, presence=presence, reps=reps, freqs=freqs,
        press=press))
    assert toks.tolist() == [1, 0]


def _dense_token_logprobs(model, prompt, generated):
    """Expected logprobs: log_softmax of the dense next-token logits at
    each generated position."""
    toks = list(prompt) + list(generated)
    logits = _dense_logits(model, toks).astype(np.float64)
    out = []
    for t, tok in enumerate(generated):
        row = logits[len(prompt) + t - 1]
        row = row - row.max()
        out.append(row[tok] - np.log(np.exp(row).sum()))
    return out


@pytest.mark.parametrize("steps_per_dispatch", [1, 4])
def test_token_logprobs_match_dense(model, steps_per_dispatch):
    """Every landed token carries its raw-model logprob, exact vs a dense
    forward, through both the single-step and chunked decode paths (and
    the batched prefill seed)."""
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=16,
                                   pages_per_seq=4,
                                   steps_per_dispatch=steps_per_dispatch)
    reqs = [eng.submit([5, 9, 2], 10), eng.submit([7, 1], 8)]
    eng.run()
    for req in reqs:
        assert len(req.token_logprobs) == len(req.generated)
        want = _dense_token_logprobs(model, req.prompt, req.generated)
        np.testing.assert_allclose(req.token_logprobs, want,
                                   atol=1e-4, rtol=1e-4)


def test_token_logprobs_chunked_prefill(model):
    """Long prompts through the chunked-prefill path still seed a correct
    first-token logprob."""
    rng = np.random.default_rng(3)
    prompt = list(rng.integers(1, 60, size=37))
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                   pages_per_seq=8, prefill_chunk=16)
    req = eng.submit(prompt, 6)
    eng.run()
    assert len(req.token_logprobs) == len(req.generated)
    want = _dense_token_logprobs(model, req.prompt, req.generated)
    np.testing.assert_allclose(req.token_logprobs, want, atol=1e-4, rtol=1e-4)


def test_token_logprobs_speculative(model):
    """The speculative path's accepted tokens carry target-model logprobs
    identical to the plain greedy engine's."""
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                   pages_per_seq=4, draft_model=model,
                                   spec_len=4)
    req = eng.submit([5, 9, 2], 10)
    eng.run()
    plain_eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                         pages_per_seq=4)
    plain = plain_eng.submit([5, 9, 2], 10)
    plain_eng.run()
    assert req.generated == plain.generated
    assert len(req.token_logprobs) == len(req.generated)
    np.testing.assert_allclose(req.token_logprobs, plain.token_logprobs,
                               atol=1e-4, rtol=1e-4)


def test_token_logprobs_trimmed_with_stop(model):
    """Stop-sequence trimming keeps token_logprobs in lockstep with
    generated."""
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                   pages_per_seq=4, steps_per_dispatch=4)
    probe = eng.submit([5, 9, 2], 10)
    eng.run()
    assert len(probe.generated) >= 4
    stop = [probe.generated[2:4]]
    eng2 = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                    pages_per_seq=4, steps_per_dispatch=4)
    req = eng2.submit([5, 9, 2], 10, stop=stop)
    eng2.run()
    assert req.generated == probe.generated[:4]
    assert req.token_logprobs == probe.token_logprobs[:4]


def test_engine_gqa_model_matches_dense():
    """Full engine loop over a GQA model (2 kv heads under 4 q heads):
    paged pools are allocated at h_kv width and the decode/prefill kernels
    fold the query-head group — logits must equal the dense forward."""
    gqa = ft.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                       n_kv_head=2, attn_impl="flash",
                       key=jax.random.PRNGKey(3)).eval()
    trajectories = [[1, 5, 9, 11, 2], [3, 3, 7, 50, 1, 4, 8]]
    _assert_engine_matches_dense(gqa, trajectories, max_batch=2,
                                 page_size=16, pages_per_seq=4)


def test_engine_stats_snapshot(model):
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=16,
                                   pages_per_seq=4)
    reqs = [eng.submit([5, 9, 2], 6), eng.submit([7, 1], 4)]
    eng.run()
    s = eng.stats()
    assert s["finished_requests"] == 2
    assert s["active_requests"] == 0 and s["queued_requests"] == 0
    assert s["generated_tokens"] == sum(len(r.generated) for r in reqs)
    assert s["pages_free"] == s["pages_total"]


def test_sampled_output_independent_of_batch_composition(model):
    """Sampling randomness is f(request seed, position): a sampled request
    produces the SAME tokens whether it runs alone, with neighbors, or at a
    different slot/submission position — no cross-request RNG coupling."""
    prompt, n_new = [5, 9, 2], 12
    alone_eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                         pages_per_seq=4)
    alone = alone_eng.submit(prompt, n_new, temperature=0.9, seed=42)
    alone_eng.run()

    eng = ContinuousBatchingEngine(model, max_batch=4, page_size=16,
                                   pages_per_seq=4, seed=777)
    eng.submit([7, 1, 3, 4], 8, temperature=0.5)
    batched = eng.submit(prompt, n_new, temperature=0.9, seed=42)
    eng.submit([11, 30], 10)
    eng.run()
    assert batched.generated == alone.generated
    np.testing.assert_allclose(batched.token_logprobs, alone.token_logprobs,
                               atol=1e-4, rtol=1e-4)

    # chunked decode path (steps_per_dispatch > 1) draws the same stream
    eng2 = ContinuousBatchingEngine(model, max_batch=2, page_size=16,
                                    pages_per_seq=4, steps_per_dispatch=4)
    chunked = eng2.submit(prompt, n_new, temperature=0.9, seed=42)
    eng2.run()
    assert chunked.generated == alone.generated


def test_sampled_seeds_differ(model):
    """Different request seeds explore different trajectories (engine-level
    sanity that the seed is actually wired through)."""
    outs = set()
    for seed in range(4):
        eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                       pages_per_seq=4)
        r = eng.submit([5, 9, 2], 10, temperature=1.5, seed=seed)
        eng.run()
        outs.add(tuple(r.generated))
    assert len(outs) >= 2


def test_quantized_pools_compose_with_prompt_lookup(model):
    """INT8 paged KV + prompt-lookup waves: the speculative verify writes
    quantized pages exactly like plain decode, so the lookup engine's
    output equals the plain int8 engine's (both greedy over the same
    quantized history)."""
    prompt = [5, 9, 2, 5, 9, 2, 5, 9, 2]
    plain = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                     pages_per_seq=4, dtype=jnp.int8)
    want = plain.submit(list(prompt), 10)
    plain.run()
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=16,
                                   pages_per_seq=4, dtype=jnp.int8,
                                   prompt_lookup=3)
    req = eng.submit(list(prompt), 10)
    eng.run()
    assert req.generated == want.generated
    assert eng.pool.n_free == eng.pool.total
