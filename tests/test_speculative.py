"""Speculative decoding: greedy acceptance makes the engine's output
token-for-token IDENTICAL to plain greedy decoding — the strongest possible
equivalence test, fuzzed over scheduler configurations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import flashattn_tpu as ft
from flashattn_tpu.serving import ContinuousBatchingEngine

V = 64


@pytest.fixture(scope="module")
def target():
    return ft.DecoderLM(V, 32, 4, 512, p_dropout=0.0, n_layer=2,
                        attn_impl="flash",
                        key=jax.random.PRNGKey(0)).eval()


@pytest.fixture(scope="module")
def draft():
    # a different (smaller) model: proposals only partially match, so the
    # acceptance logic is genuinely exercised
    return ft.DecoderLM(V, 16, 2, 512, p_dropout=0.0, n_layer=1,
                        attn_impl="flash",
                        key=jax.random.PRNGKey(7)).eval()


def _run(target_model, prompts, maxnews, eoss, **kw):
    eng = ContinuousBatchingEngine(target_model, **kw)
    reqs = [eng.submit(p, m, eos_id=e)
            for p, m, e in zip(prompts, maxnews, eoss)]
    eng.run()
    assert eng.pool.n_free == eng.pool.total
    return {r.uid: (r.generated, r.truncated) for r in reqs}, eng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_equals_greedy(target, draft, seed):
    rng = np.random.default_rng(seed)
    page_size = int(rng.choice([4, 8]))
    pages_per_seq = int(rng.integers(3, 6))
    max_batch = int(rng.integers(1, 4))
    capacity = page_size * pages_per_seq
    total_pages = int(rng.integers(max(3, max_batch),
                                   max_batch * pages_per_seq + 1))
    spec_len = int(rng.choice([2, 3, 4]))

    prompts, maxnews, eoss = [], [], []
    for _ in range(int(rng.integers(3, 7))):
        plen = int(rng.integers(1, capacity - 1))
        if -(-plen // page_size) > total_pages:
            continue
        prompts.append(list(rng.integers(1, 60, size=plen)))
        maxnews.append(int(rng.integers(1, capacity)))
        eoss.append(int(rng.integers(1, 60)) if rng.random() < 0.4 else None)
    if not prompts:
        return

    kw = dict(max_batch=max_batch, page_size=page_size,
              pages_per_seq=pages_per_seq, total_pages=total_pages)
    plain, _ = _run(target, prompts, maxnews, eoss,
                    steps_per_dispatch=1, **kw)
    spec, eng = _run(target, prompts, maxnews, eoss,
                     draft_model=draft, spec_len=spec_len, **kw)
    assert plain == spec, (
        f"speculative diverged: page={page_size} pps={pages_per_seq} "
        f"mb={max_batch} pool={total_pages} spec={spec_len}")
    assert eng.spec_stats[1] > 0  # the speculative path actually ran


def test_self_draft_accepts_everything(target):
    """Draft == target => every wave accepts all spec_len tokens."""
    eng = ContinuousBatchingEngine(target, max_batch=2, page_size=8,
                                   pages_per_seq=8, draft_model=target,
                                   spec_len=4)
    reqs = [eng.submit([3, 14, 15], 17), eng.submit([9, 2], 13)]
    eng.run()
    for r in reqs:
        assert r.done
    acc, waves = eng.spec_stats
    assert waves > 0
    # all-but-final waves accept the full chunk; the mean stays close to 4
    assert acc / waves > 3.0, eng.spec_stats


def test_speculative_with_rolling_window(draft):
    """Windowed target + draft: speculative, rolling release and the
    windowed kernels compose; output equals plain greedy."""
    wtarget = ft.DecoderLM(V, 32, 4, 512, p_dropout=0.0, n_layer=2,
                           window=8, attn_impl="flash",
                           key=jax.random.PRNGKey(1)).eval()
    wdraft = ft.DecoderLM(V, 16, 2, 512, p_dropout=0.0, n_layer=1,
                          window=8, attn_impl="flash",
                          key=jax.random.PRNGKey(8)).eval()
    prompts = [[3, 14, 15, 9, 2, 6], [27, 1, 8]]
    kw = dict(max_batch=2, page_size=4, pages_per_seq=8)
    plain, _ = _run(wtarget, prompts, [20, 24], [None, None],
                    steps_per_dispatch=1, **kw)
    spec, eng = _run(wtarget, prompts, [20, 24], [None, None],
                     draft_model=wdraft, spec_len=3, **kw)
    assert plain == spec
    assert eng.spec_stats[1] > 0


def test_speculative_with_tp_serving(target, draft):
    """Speculative + TP serving composed: draft sharded over the same
    (mesh, head_axis) as the target; output identical to the plain
    unsharded greedy engine."""
    from flashattn_tpu.parallel import create_mesh

    mesh = create_mesh((2,), ("model",))
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(1, 60, size=n)) for n in (5, 12, 1)]
    maxnews, eoss = [10, 6, 8], [None, None, None]

    kw = dict(max_batch=3, page_size=8, pages_per_seq=4)
    plain, _ = _run(target, prompts, maxnews, eoss,
                    steps_per_dispatch=1, **kw)
    spec, eng = _run(target, prompts, maxnews, eoss,
                     draft_model=draft, spec_len=3, mesh=mesh, **kw)
    assert plain == spec
    assert eng.spec_stats[1] > 0  # speculative waves actually ran


def test_ngram_propose_unit():
    from flashattn_tpu.serving.engine import _ngram_propose

    # trailing bigram (7, 8) occurred earlier, followed by 9, 10
    assert _ngram_propose([7, 8, 9, 10, 3, 7, 8], 2) == [9, 10]
    # longest n-gram wins: trailing (1, 2, 3) matches the first occurrence
    ctx = [1, 2, 3, 4, 5, 0, 1, 2, 3]
    assert _ngram_propose(ctx, 3, max_ngram=3) == [4, 5, 0]
    # no repeat anywhere -> no proposal
    assert _ngram_propose([1, 2, 3, 4], 4) == []
    # k truncates the continuation
    assert _ngram_propose([7, 8, 9, 10, 3, 7, 8], 1) == [9]
    # self-overlapping trailing run proposes the repeat (the longest n-gram
    # matches at position 0, whose continuation room is 1 token)
    assert _ngram_propose([5, 5, 5, 5], 2) == [5]


def _greedy_reference(target, prompt, n_new):
    eng = ContinuousBatchingEngine(target, max_batch=1, page_size=16,
                                   pages_per_seq=8)
    req = eng.submit(prompt, n_new)
    eng.run()
    return req


@pytest.mark.parametrize("prompt", [
    [5, 9, 2, 5, 9, 2, 5, 9],           # strongly repetitive
    [7, 1, 3],                           # no repeats
    list(range(1, 40)) + list(range(1, 20)),  # long, partial repeat
])
def test_prompt_lookup_token_identical_to_greedy(target, prompt):
    """Prompt-lookup speculation is greedy-exact: tokens AND logprobs match
    the plain engine for any proposal quality."""
    want = _greedy_reference(target, prompt, 12)
    eng = ContinuousBatchingEngine(target, max_batch=1, page_size=16,
                                   pages_per_seq=8, prompt_lookup=3)
    req = eng.submit(prompt, 12)
    eng.run()
    assert req.generated == want.generated
    np.testing.assert_allclose(req.token_logprobs, want.token_logprobs,
                               atol=1e-4, rtol=1e-4)
    assert eng.pool.n_free == eng.pool.total


def test_prompt_lookup_waves_run(target):
    """A prompt containing every vocab token guarantees an n=1 match for
    whatever the model emits, so lookup waves must actually run — and the
    output still matches plain greedy exactly."""
    prompt = list(range(64)) + [5, 9, 2]
    want = _greedy_reference(target, prompt, 12)
    eng = ContinuousBatchingEngine(target, max_batch=1, page_size=16,
                                   pages_per_seq=8, prompt_lookup=3)
    req = eng.submit(prompt, 12)
    eng.run()
    assert req.generated == want.generated
    np.testing.assert_allclose(req.token_logprobs, want.token_logprobs,
                               atol=1e-4, rtol=1e-4)
    assert eng.lookup_stats[1] > 0          # waves actually ran
    assert eng.pool.n_free == eng.pool.total


def test_prompt_lookup_batch_mixed(target):
    """Mixed batch: some rows propose, some don't; mid-flight admission
    falls back correctly and every request matches plain greedy."""
    prompts = [[5, 9, 2, 5, 9, 2], [7, 1, 3], [4, 4, 4, 4, 4],
               [11, 3, 11, 3, 11]]
    wants = [_greedy_reference(target, p, 10).generated for p in prompts]
    eng = ContinuousBatchingEngine(target, max_batch=2, page_size=16,
                                   pages_per_seq=8, prompt_lookup=3)
    reqs = [eng.submit(p, 10) for p in prompts]
    eng.run()
    for r, w in zip(reqs, wants):
        assert r.generated == w
    assert eng.pool.n_free == eng.pool.total


def test_prompt_lookup_rejects_draft_model(target):
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(target, draft_model=target, prompt_lookup=3)


def test_prompt_lookup_with_stop_and_eos(target):
    """Wave overshoot composes with stop-sequence trimming and EOS."""
    probe = _greedy_reference(target, [5, 9, 2, 5, 9, 2], 12)
    assert len(probe.generated) >= 5
    stop = [probe.generated[3:5]]
    eng = ContinuousBatchingEngine(target, max_batch=1, page_size=16,
                                   pages_per_seq=8, prompt_lookup=3)
    req = eng.submit([5, 9, 2, 5, 9, 2], 12, stop=stop)
    eng.run()
    assert req.generated == probe.generated[:5]
    assert len(req.token_logprobs) == len(req.generated)


def test_spec_accept_sampled_exact_marginals():
    """The accept/residual wave's landed tokens must be distributed EXACTLY
    as the temperature-scaled target distribution, position by position
    (the speculative-sampling theorem for a point-mass draft).  4000
    independent rows of the same (logits, proposal) = 4000 trials in one
    call; empirical marginals vs softmax within 4 sigma."""
    from flashattn_tpu.serving.engine import _spec_accept_sampled

    B, V = 4000, 4
    base = jnp.asarray([[2.0, 1.0, 0.0, -1.0],    # position 0
                        [0.5, 0.5, 1.5, -0.5],    # position 1 (after d1)
                        [1.0, 1.0, 1.0, 1.0]])    # position 2 (bonus)
    logits = jnp.broadcast_to(base, (B, 3, V))
    proposed = jnp.broadcast_to(jnp.asarray([1, 2], jnp.int32), (B, 2))
    temps = jnp.full((B,), 0.7, jnp.float32)
    n_acc, toks, lps = _spec_accept_sampled(
        logits, proposed, temps, jnp.arange(B, dtype=jnp.int32),
        jnp.zeros((B,), jnp.int32))
    n_acc, toks = np.asarray(n_acc), np.asarray(toks)

    def check(row_sel, pos, target_logits):
        sel = toks[row_sel, pos]
        p = np.asarray(jax.nn.softmax(target_logits / 0.7))
        for x in range(V):
            emp = float((sel == x).mean())
            sig = max((p[x] * (1 - p[x]) / max(len(sel), 1)) ** 0.5, 1e-4)
            assert abs(emp - p[x]) < 4 * sig + 1e-3, (pos, x, emp, p[x])

    # first landed token: full-batch marginal must be p0
    check(np.ones(B, bool), 0, base[0])
    # second landed token, conditioned on the first proposal's acceptance
    accepted = n_acc >= 1
    assert 0.05 < accepted.mean() < 0.95    # both branches exercised
    check(accepted, 1, base[1])
    # logprobs are the raw-model (temperature-free) log-softmax of toks
    want0 = np.asarray(jax.nn.log_softmax(base[0]))[toks[:, 0]]
    np.testing.assert_allclose(np.asarray(lps)[:, 0], want0, atol=1e-5)


def test_spec_accept_sampled_greedy_rows_deterministic():
    """temperature-0 rows through the sampled wave use argmax acceptance:
    proposal == argmax prefix accepted, bonus = argmax."""
    from flashattn_tpu.serving.engine import _spec_accept_sampled

    logits = jnp.asarray([[[0.0, 3.0, 0.0, 0.0],   # argmax 1
                           [0.0, 0.0, 3.0, 0.0],   # argmax 2
                           [3.0, 0.0, 0.0, 0.0]],  # argmax 0
                          [[0.0, 3.0, 0.0, 0.0],
                           [0.0, 0.0, 3.0, 0.0],
                           [3.0, 0.0, 0.0, 0.0]]])
    temps = jnp.zeros((2,), jnp.float32)
    # row 0 proposes [1, 2] (both match argmax) -> n_acc 2, lands [1, 2, 0]
    # row 1 proposes [3, 2] (first mismatches)  -> n_acc 0, lands [1]
    proposed = jnp.asarray([[1, 2], [3, 2]], jnp.int32)
    n_acc, toks, _ = _spec_accept_sampled(logits, proposed, temps,
                                          jnp.arange(2, dtype=jnp.int32),
                                          jnp.zeros((2,), jnp.int32))
    assert np.asarray(n_acc).tolist() == [2, 0]
    assert np.asarray(toks)[0].tolist() == [1, 2, 0]
    assert int(np.asarray(toks)[1, 0]) == 1


def test_prompt_lookup_sampled_mixed_batch(target):
    """Mixed greedy + sampled batch through the sampled wave: the greedy
    row stays token-identical to the plain greedy engine, the sampled row
    completes with logprobs in lockstep, pages all return."""
    prompt = list(range(1, 30)) + list(range(1, 15))   # repeat-y
    want = _greedy_reference(target, prompt, 10)
    eng = ContinuousBatchingEngine(target, max_batch=2, page_size=16,
                                   pages_per_seq=8, prompt_lookup=3)
    r_greedy = eng.submit(list(prompt), 10)
    r_sampled = eng.submit(list(prompt), 10, temperature=0.9)
    eng.run()
    assert r_greedy.generated == want.generated
    assert len(r_sampled.generated) == 10
    assert len(r_sampled.token_logprobs) == 10
    assert eng.pool.n_free == eng.pool.total
    assert eng.lookup_stats[1] > 0


def test_draft_spec_sampled_mixed_batch(target, draft):
    """Draft-model speculation under sampling: greedy rows stay
    token-identical to the plain engine, sampled rows complete with
    logprobs in lockstep, waves actually run."""
    rng = np.random.default_rng(21)
    prompt = list(rng.integers(1, 60, size=8))
    want = _greedy_reference(target, prompt, 12)
    eng = ContinuousBatchingEngine(target, max_batch=2, page_size=16,
                                   pages_per_seq=8, draft_model=draft,
                                   spec_len=3)
    r_greedy = eng.submit(list(prompt), 12)
    r_sampled = eng.submit(list(prompt), 12, temperature=0.8)
    eng.run()
    assert r_greedy.generated == want.generated
    assert len(r_sampled.generated) == 12
    assert len(r_sampled.token_logprobs) == 12
    assert eng.spec_stats[1] > 0
    assert eng.pool.n_free == eng.pool.total
