"""Prefix caching: shared full prompt pages across requests — correctness
(logits identical to uncached), refcount/pool accounting, and eviction
under pool pressure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import flashattn_tpu as ft
from flashattn_tpu.serving import ContinuousBatchingEngine

V = 64


@pytest.fixture(scope="module")
def model():
    return ft.DecoderLM(V, 32, 4, 512, p_dropout=0.0, n_layer=2,
                        attn_impl="flash",
                        key=jax.random.PRNGKey(0)).eval()


def _mkengine(model, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("pages_per_seq", 8)
    kw.setdefault("enable_prefix_cache", True)
    return ContinuousBatchingEngine(model, **kw)


def _nocache_generated(model, prompt, max_new, **kw):
    eng = _mkengine(model, enable_prefix_cache=False, **kw)
    r = eng.submit(list(prompt), max_new)
    eng.run()
    return r.generated


def test_cache_hit_matches_uncached(model):
    """Second request with the same prompt attaches cached pages, skips
    their prefill, and generates exactly what an uncached engine does."""
    rng = np.random.default_rng(0)
    prompt = list(rng.integers(1, 60, 13))           # 3 full pages + tail
    eng = _mkengine(model)
    r1 = eng.submit(prompt, 5)
    eng.run()
    assert eng._prefix_cache                         # pages registered
    n_cached = len(eng._prefix_cache)

    r2 = eng.submit(prompt + [7, 9], 6)              # shared prefix, longer
    eng.run()
    assert len(eng._prefix_cache) >= n_cached
    assert r1.generated == _nocache_generated(model, prompt, 5)
    assert r2.generated == _nocache_generated(model, prompt + [7, 9], 6)

    # accounting: every page is either free or held only by the cache
    cached = set(eng._prefix_cache.values())
    assert all(eng._page_refs[p] == 1 for p in cached)
    assert eng.pool.n_free + len(cached) == eng.pool.total


def test_divergent_prefix_shares_only_common_pages(model):
    rng = np.random.default_rng(1)
    common = list(rng.integers(1, 60, 8))            # 2 full pages
    eng = _mkengine(model)
    r1 = eng.submit(common + [11, 12, 13], 4)
    eng.run()
    r2 = eng.submit(common + [21, 22, 23], 4)        # diverges after page 2
    eng.run()
    assert r1.generated == _nocache_generated(model, common + [11, 12, 13], 4)
    assert r2.generated == _nocache_generated(model, common + [21, 22, 23], 4)


def test_eviction_under_pressure(model):
    """A full cache must not block new admissions: cache-only pages evict
    LRU and the pool invariant holds."""
    rng = np.random.default_rng(2)
    eng = _mkengine(model, max_batch=1, pages_per_seq=4, total_pages=6,
                    collect_logits=False)
    outs = []
    for t in range(6):                               # distinct prompts
        r = eng.submit(list(rng.integers(1, 60, 9)), 4)
        eng.run()
        outs.append(r)
    assert all(r.done and not r.truncated for r in outs)
    cached = set(eng._prefix_cache.values())
    assert eng.pool.n_free + len(cached) == eng.pool.total


def test_cache_equals_nocache_outputs(model):
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, 60, n)) for n in (13, 13, 9)]

    def run(flag):
        eng = _mkengine(model, enable_prefix_cache=flag,
                        collect_logits=False)
        out = []
        for p in prompts:
            r = eng.submit(p, 8)
            eng.run()
            out.append(r.generated)
        return out

    assert run(True) == run(False)


def test_prefix_cache_composes_with_prompt_lookup(model):
    """Cached prefix pages + prompt-lookup waves: the second request
    attaches to the first's prompt pages, lookup waves write only past the
    shared prefix, and outputs stay identical to a plain engine."""
    prompt = [5, 9, 2, 5, 9, 2, 5, 9, 2, 5, 9, 2]   # 3 full pages at size 4
    want = _nocache_generated(model, prompt, 10)
    eng = _mkengine(model, prompt_lookup=3)
    r1 = eng.submit(list(prompt), 10)
    eng.run()
    r2 = eng.submit(list(prompt), 10)
    eng.run()
    assert r1.generated == want
    assert r2.generated == want
