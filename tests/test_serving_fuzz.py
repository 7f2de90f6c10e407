"""Randomized scheduler fuzz: many engine configurations × request mixes,
every finished request's logits checked against the dense forward.

The engine's failure modes are scheduling bugs (stale page tables, slot
reuse, boundary off-by-ones) that only bite under particular interleavings —
this sweeps interleavings the targeted tests don't."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import flashattn_tpu as ft
from flashattn_tpu.serving import ContinuousBatchingEngine


@pytest.fixture(scope="module")
def model():
    return ft.DecoderLM(64, 32, 4, 512, p_dropout=0.0, n_layer=2,
                        attn_impl="flash", key=jax.random.PRNGKey(0)).eval()


def _dense_logits(model, tokens):
    return np.asarray(model(jnp.asarray([tokens], jnp.int32))[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_fuzz_chunked(model, seed):
    """Fuzz the multi-step (chunked) decode path: collect_logits=False so
    _decode_chunk_len actually returns >1 and the lax.scan step runs.  Greedy
    decoding is key-independent, so a chunked engine must emit exactly the
    same tokens as a per-token (steps_per_dispatch=1) engine over the same
    requests — any divergence is a chunk-scheduling bug (lengths carry,
    page-boundary splits, EOS-inside-chunk discards)."""
    rng = np.random.default_rng(100 + seed)
    page_size = int(rng.choice([4, 8, 16]))
    pages_per_seq = int(rng.integers(2, 5))
    max_batch = int(rng.integers(1, 4))
    capacity = page_size * pages_per_seq
    total_pages = int(rng.integers(max(2, max_batch),
                                   max_batch * pages_per_seq + 1))
    chunk = int(rng.choice([4, 8]))

    def build(steps_per_dispatch):
        return ContinuousBatchingEngine(
            model, max_batch=max_batch, page_size=page_size,
            pages_per_seq=pages_per_seq, total_pages=total_pages,
            steps_per_dispatch=steps_per_dispatch, collect_logits=False)

    prompts = []
    for _ in range(int(rng.integers(3, 7))):
        plen = int(rng.integers(1, capacity))
        if max(1, -(-plen // page_size)) > total_pages:
            continue
        eos = int(rng.integers(1, 60)) if rng.random() < 0.5 else None
        prompts.append((list(rng.integers(1, 60, size=plen)),
                        int(rng.integers(1, capacity)), eos))
    if not prompts:
        return

    results = []
    for spd in (1, chunk):
        eng = build(spd)
        reqs = [eng.submit(p, m, eos_id=e) for p, m, e in prompts]
        eng.run()
        assert eng.pool.n_free == eng.pool.total
        results.append({r.uid: (r.generated, r.truncated) for r in reqs})

    assert results[0] == results[1], (
        f"chunked (spd={chunk}) diverged from per-token decode: "
        f"page={page_size} pps={pages_per_seq} mb={max_batch} "
        f"pool={total_pages}")


def test_chunked_sampling_topk1_matches_greedy(model):
    """temperature>0 with top_k=1 is argmax regardless of PRNG key — a sharp
    check that the sampling path wired through the chunked lax.scan decode
    (collect_logits=False, temps>0 so the greedy fast path is OFF) agrees
    with greedy decoding."""
    prompts = [[3, 14, 15, 9], [26, 5], [35, 8, 9, 7, 9, 3]]

    def run(temperature, top_k):
        eng = ContinuousBatchingEngine(
            model, max_batch=4, page_size=8, pages_per_seq=4,
            steps_per_dispatch=8, collect_logits=False, seed=7)
        reqs = [eng.submit(p, 20, temperature=temperature, top_k=top_k)
                for p in prompts]
        eng.run()
        return [r.generated for r in reqs]

    assert run(1.0, 1) == run(0.0, None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_fuzz(model, seed):
    rng = np.random.default_rng(seed)
    page_size = int(rng.choice([4, 8, 16]))
    pages_per_seq = int(rng.integers(2, 5))
    max_batch = int(rng.integers(1, 4))
    capacity = page_size * pages_per_seq
    # sometimes over-commit the pool to exercise truncation
    total_pages = int(rng.integers(max(2, max_batch),
                                   max_batch * pages_per_seq + 1))

    eng = ContinuousBatchingEngine(
        model, max_batch=max_batch, page_size=page_size,
        pages_per_seq=pages_per_seq, total_pages=total_pages,
        steps_per_dispatch=int(rng.choice([1, 4, 8])),
        collect_logits=True)

    reqs = []
    for _ in range(int(rng.integers(3, 7))):
        plen = int(rng.integers(1, capacity))
        need = max(1, -(-plen // page_size))
        if need > total_pages:
            continue
        prompt = list(rng.integers(1, 60, size=plen))
        max_new = int(rng.integers(1, capacity))
        reqs.append(eng.submit(prompt, max_new))
    if not reqs:
        return
    eng.run()
    assert eng.pool.n_free == eng.pool.total

    for r in reqs:
        assert r.done
        full = r.prompt + r.generated
        n_logits = len(r.logits)
        # logits row t is the prediction after consuming full[:t+1]
        want = _dense_logits(model, full[:n_logits])
        got = np.stack(r.logits)
        np.testing.assert_allclose(
            got, want, atol=2e-4, rtol=2e-4,
            err_msg=f"uid={r.uid} plen={len(r.prompt)} gen={len(r.generated)} "
                    f"page={page_size} pps={pages_per_seq} mb={max_batch} "
                    f"pool={total_pages} trunc={r.truncated}")
        if not r.truncated:
            assert (len(r.generated) == r.max_new_tokens
                    or len(full) >= capacity)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_fuzz_random_cancels(model, seed):
    """Random cancels mid-flight (queued and active, sometimes via the bare
    cancelled flag) across mixed configurations: pool accounting must
    balance, surviving requests must finish, cancelled ones must stop."""
    rng = np.random.default_rng(300 + seed)
    page_size = int(rng.choice([4, 8, 16]))
    pages_per_seq = int(rng.integers(2, 5))
    max_batch = int(rng.integers(1, 4))
    capacity = page_size * pages_per_seq
    eng = ContinuousBatchingEngine(
        model, max_batch=max_batch, page_size=page_size,
        pages_per_seq=pages_per_seq,
        steps_per_dispatch=int(rng.choice([1, 4])))
    reqs = []
    for _ in range(int(rng.integers(4, 9))):
        plen = int(rng.integers(1, max(2, capacity - 2)))
        prompt = rng.integers(0, 64, size=plen).tolist()
        reqs.append(eng.submit(
            prompt, int(rng.integers(1, 8)),
            on_token=lambda r, new: None))
    cancelled = set()
    for step_i in range(200):
        if not eng.step():
            break
        if rng.random() < 0.4 and len(cancelled) < len(reqs):
            victim = reqs[int(rng.integers(0, len(reqs)))]
            if not victim.done:
                if rng.random() < 0.5:
                    eng.cancel(victim)
                else:
                    victim.cancelled = True  # honored next step
                cancelled.add(victim.uid)
    else:
        pytest.fail("engine did not drain in 200 steps")
    assert all(r.done for r in reqs)
    assert eng.pool.n_free == eng.pool.total, "leaked KV pages"
    for r in reqs:
        if r.cancelled:
            assert len(r.generated) <= r.max_new_tokens
        else:
            hit_capacity = len(r.prompt) + len(r.generated) >= capacity
            assert (len(r.generated) == r.max_new_tokens or r.truncated
                    or hit_capacity)


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_fuzz_chunked_with_penalties(model, seed):
    """Chunked-vs-per-token equality under the full deterministic sampling
    feature mix: repetition/frequency/presence penalties apply to greedy
    decoding too, and their presence carry through the chunked lax.scan
    (mid-chunk updates) must agree with per-token stepping."""
    rng = np.random.default_rng(500 + seed)
    max_batch = int(rng.integers(1, 4))

    def build(spd):
        return ContinuousBatchingEngine(
            model, max_batch=max_batch, page_size=8, pages_per_seq=4,
            steps_per_dispatch=spd)

    prompts = []
    for _ in range(int(rng.integers(3, 6))):
        plen = int(rng.integers(1, 20))
        kw = {}
        mode = rng.integers(0, 4)
        if mode == 1:
            kw["repetition_penalty"] = float(rng.uniform(1.1, 2.0))
        elif mode == 2:
            kw["frequency_penalty"] = float(rng.uniform(0.1, 1.0))
            kw["presence_penalty"] = float(rng.uniform(0.0, 1.0))
        elif mode == 3:
            kw["repetition_penalty"] = float(rng.uniform(1.1, 1.5))
            kw["frequency_penalty"] = float(rng.uniform(0.1, 0.5))
        prompts.append((list(rng.integers(1, 60, size=plen)),
                        int(rng.integers(4, 16)), kw))

    results = []
    for spd in (1, 4):
        eng = build(spd)
        reqs = [eng.submit(p, m, **kw) for p, m, kw in prompts]
        eng.run()
        assert eng.pool.n_free == eng.pool.total
        results.append({r.uid: (r.generated,
                                [round(l, 4) for l in r.token_logprobs])
                        for r in reqs})
    assert results[0] == results[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_fuzz_prompt_lookup(model, seed):
    """Prompt-lookup engine vs plain engine over random request mixes
    (repetitive and non-repetitive prompts, EOS, varying lengths): outputs
    and logprobs must be identical — speculation is an optimization, never
    a semantics change."""
    rng = np.random.default_rng(900 + seed)
    max_batch = int(rng.integers(1, 4))

    prompts = []
    for _ in range(int(rng.integers(3, 6))):
        if rng.random() < 0.5:  # repetition-heavy prompt
            pat = list(rng.integers(1, 8, size=int(rng.integers(2, 5))))
            p = (pat * 6)[:int(rng.integers(6, 20))]
        else:
            p = list(rng.integers(1, 60, size=int(rng.integers(1, 20))))
        eos = int(rng.integers(1, 60)) if rng.random() < 0.3 else None
        prompts.append((p, int(rng.integers(4, 20)), eos))

    results = []
    for lookup in (0, 3):
        eng = ContinuousBatchingEngine(
            model, max_batch=max_batch, page_size=8, pages_per_seq=6,
            prompt_lookup=lookup)
        reqs = [eng.submit(p, m, eos_id=e) for p, m, e in prompts]
        eng.run()
        assert eng.pool.n_free == eng.pool.total
        results.append({r.uid: (r.generated,
                                [round(l, 4) for l in r.token_logprobs])
                        for r in reqs})
    assert results[0] == results[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_fuzz_spec_scan(model, seed):
    """Multi-wave speculative scan (device-side acceptance) vs the
    single-wave host loop vs the plain engine, over random request mixes
    with EOS and varying lengths: greedy speculation is exact, so all three
    must produce identical tokens and logprobs."""
    rng = np.random.default_rng(1100 + seed)
    max_batch = int(rng.integers(1, 4))

    prompts = []
    for _ in range(int(rng.integers(3, 6))):
        p = list(rng.integers(1, 60, size=int(rng.integers(1, 16))))
        eos = int(rng.integers(1, 60)) if rng.random() < 0.3 else None
        prompts.append((p, int(rng.integers(3, 18)), eos))

    results = []
    for cfg in ({},
                dict(draft_model=model, spec_len=4,
                     spec_waves_per_dispatch=1),
                dict(draft_model=model, spec_len=4,
                     spec_waves_per_dispatch=4)):
        eng = ContinuousBatchingEngine(
            model, max_batch=max_batch, page_size=8, pages_per_seq=8, **cfg)
        reqs = [eng.submit(p, m, eos_id=e) for p, m, e in prompts]
        eng.run()
        assert eng.pool.n_free == eng.pool.total
        results.append({r.uid: (r.generated,
                                [round(l, 4) for l in r.token_logprobs])
                        for r in reqs})
    assert results[0] == results[1]
    assert results[0] == results[2]
