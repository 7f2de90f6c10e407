"""Native C++ data loader vs the Python collate oracle."""

import numpy as np
import pytest

pytest.importorskip("ctypes")

from flashattn_tpu.utils.native_loader import NativeDataLoader, build_native


def _python_collate(src, tgt, pad_id, max_len):
    """Reference collate semantics (translation.collate_batch)."""
    ids = (src + tgt)[:max_len]
    mask = ([0] * len(src) + [1] * len(tgt))[:max_len]
    pad = [pad_id] * (max_len - len(ids))
    ids = ids + pad
    mask = mask + [0] * len(pad)
    return (np.asarray(ids[:-1]), np.asarray(ids[1:]),
            np.asarray(mask[1:], np.float32))


def test_native_builds():
    path = build_native()
    assert path.endswith("libdataloader.so")


def test_native_collate_matches_python():
    examples = [
        ([1, 2, 3], [10, 11]),
        ([4], [12, 13, 14, 15]),
        ([5, 6, 7, 8, 9, 16, 17, 18], [19, 20, 21]),  # truncation case
    ]
    pad_id, max_len = 0, 8
    # batch == corpus size and one epoch -> every example appears exactly once
    loader = NativeDataLoader(examples, pad_id, max_len, batch_size=3, seed=1)
    batch = loader.next_batch()
    loader.close()

    expected = {tuple(_python_collate(s, t, pad_id, max_len)[0]): (s, t)
                for s, t in examples}
    for row in range(3):
        key = tuple(batch["input_ids"][row])
        assert key in expected, f"unexpected row {key}"
        s, t = expected.pop(key)
        exp_in, exp_lb, exp_w = _python_collate(s, t, pad_id, max_len)
        np.testing.assert_array_equal(batch["input_ids"][row], exp_in)
        np.testing.assert_array_equal(batch["labels"][row], exp_lb)
        np.testing.assert_array_equal(batch["label_token_weights"][row], exp_w)
    assert not expected


def test_native_loader_epochs_reshuffle():
    examples = [([i, i + 1], [i + 2]) for i in range(1, 50)]
    loader = NativeDataLoader(examples, 0, 6, batch_size=16, seed=7)
    batches = [loader.next_batch() for _ in range(8)]  # crosses epoch boundary
    loader.close()
    # all batches well-formed
    for b in batches:
        assert b["input_ids"].shape == (16, 5)
        assert (b["label_token_weights"] >= 0).all()


def test_native_loader_prefetch_throughput():
    examples = [([i % 100, 2, 3, 4], [5, 6, 7]) for i in range(1000)]
    loader = NativeDataLoader(examples, 0, 12, batch_size=128, seed=0)
    import time
    t0 = time.perf_counter()
    for _ in range(50):
        loader.next_batch()
    dt = time.perf_counter() - t0
    loader.close()
    assert dt < 5.0  # 50 batches of 128 well under 5s

def test_ngram_propose_native_matches_python():
    """The C++ proposer (native/ngram.cc) and the Python fallback must be
    behaviourally identical — fuzz across context lengths, vocab sizes
    (repeat-heavy and repeat-free), k and max_ngram."""
    from flashattn_tpu.serving.engine import _ngram_propose
    from flashattn_tpu.utils.native_loader import ngram_propose_native

    rng = np.random.default_rng(0)
    for trial in range(300):
        L = int(rng.integers(0, 60))
        vocab = int(rng.integers(2, 8 if trial % 2 else 500))
        ctx = rng.integers(0, vocab, size=L).tolist()
        k = int(rng.integers(1, 6))
        n = int(rng.integers(1, 5))
        want = _ngram_propose(ctx, k, n)
        got = ngram_propose_native(ctx, k, n)
        assert got == want, (ctx, k, n, got, want)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A build that fails raises; no earlier binary is loaded instead."""
    from flashattn_tpu.utils import native_loader

    (tmp_path / "Makefile").write_text("all:\n\tfalse\n")
    (tmp_path / "libdataloader.so").write_text("stale")
    monkeypatch.setattr(native_loader, "_NATIVE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="building native/ failed"):
        native_loader.build_native()
