"""ctypes bridge to the native C++ data loader (native/dataloader.cc).

Same binding style the reference uses for its CUDA launchers
(``minitorch/cuda_kernel_ops.py:26-29`` loads .so libs via ctypes.CDLL and
declares argtypes per call); here the native side is the host data pipeline:
one-time corpus registration, C++ collate, background prefetch thread.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import List, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdataloader.so")
_NGRAM_LIB_PATH = os.path.join(_NATIVE_DIR, "libngram.so")


def build_native() -> str:
    """Build the shared libraries from ``native/Makefile`` (they are not
    committed) and return the data loader's path.  make runs every time --
    its dependency rules are the staleness check -- under a lock on the
    Makefile, so concurrent test workers never load a half-written library.
    A failed build raises; no earlier binary is used instead."""
    with open(os.path.join(_NATIVE_DIR, "Makefile")) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            r = subprocess.run(["make", "-C", _NATIVE_DIR],
                               capture_output=True, text=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if r.returncode != 0:
        raise RuntimeError(f"building native/ failed:\n{r.stdout}{r.stderr}")
    return _LIB_PATH


def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_native())
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [i32p, i32p, i32p, ctypes.c_int64,
                                  ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32, ctypes.c_uint64]
    lib.loader_next.restype = None
    lib.loader_next.argtypes = [ctypes.c_void_p, i32p, i32p, f32p]
    lib.loader_corpus_size.restype = ctypes.c_int64
    lib.loader_corpus_size.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeDataLoader:
    """Background-prefetching batch loader over a pre-tokenized corpus.

    Produces the exact batch format of translation.collate_batch:
    (input_ids, labels, label_token_weights), each (batch, max_len - 1).
    """

    def __init__(self, examples: Sequence[Tuple[List[int], List[int]]],
                 pad_id: int, max_len: int, batch_size: int, seed: int = 0):
        self._lib = _load_lib()
        flat, src_lens, tgt_lens = [], [], []
        for src, tgt in examples:
            flat.extend(src)
            flat.extend(tgt)
            src_lens.append(len(src))
            tgt_lens.append(len(tgt))
        flat = np.asarray(flat, np.int32)
        src_lens = np.asarray(src_lens, np.int32)
        tgt_lens = np.asarray(tgt_lens, np.int32)

        i32p = ctypes.POINTER(ctypes.c_int32)
        self._handle = self._lib.loader_create(
            flat.ctypes.data_as(i32p), src_lens.ctypes.data_as(i32p),
            tgt_lens.ctypes.data_as(i32p), len(examples),
            pad_id, max_len, batch_size, seed,
        )
        self.batch_size = batch_size
        self.width = max_len - 1
        self.n_examples = len(examples)

    def next_batch(self):
        ids = np.empty((self.batch_size, self.width), np.int32)
        labels = np.empty((self.batch_size, self.width), np.int32)
        weights = np.empty((self.batch_size, self.width), np.float32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        self._lib.loader_next(self._handle, ids.ctypes.data_as(i32p),
                              labels.ctypes.data_as(i32p),
                              weights.ctypes.data_as(f32p))
        return {"input_ids": ids, "labels": labels,
                "label_token_weights": weights}

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# -- native prompt-lookup proposer (native/ngram.cc) -------------------------

_ngram_lib = None


def _load_ngram_lib() -> ctypes.CDLL:
    global _ngram_lib
    if _ngram_lib is None:
        build_native()
        lib = ctypes.CDLL(_NGRAM_LIB_PATH)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ngram_propose.restype = ctypes.c_int32
        lib.ngram_propose.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int32, i32p]
        _ngram_lib = lib
    return _ngram_lib


def ngram_propose_native(ctx, k: int, max_ngram: int = 3):
    """C++ rightmost trailing-n-gram proposal; semantics identical to
    serving.engine._ngram_propose (fuzz-tested against it).  ``ctx`` is a
    list or int32 ndarray of token ids."""
    lib = _load_ngram_lib()
    arr = np.ascontiguousarray(ctx, np.int32)
    out = np.empty((max(k, 1),), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = lib.ngram_propose(arr.ctypes.data_as(i32p), len(arr), k, max_ngram,
                          out.ctypes.data_as(i32p))
    return out[:n].tolist()
