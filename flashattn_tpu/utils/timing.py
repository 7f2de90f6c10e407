"""Timed-correctness kernel benchmark harness.

JAX equivalent of the reference's ``TestDecorator`` (test_utils.py:13-231):
register cases, draw random (batch, seq) shapes, run custom vs baseline with
warmup + repeats, assert allclose, report speedup.

Differences by design:
* :func:`device_loop_time` chains calls in a device-side ``lax.scan`` and
  takes a two-point slope, which cancels the per-dispatch host cost (the
  reference times single calls around ``torch.cuda.synchronize``,
  test_utils.py:199-205);
* determinism across repeats is a compile-level property under jit, but we
  still check it like the reference does (:207-212).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def make_timing_loop(fn: Callable, length: int):
    """The jitted scan chain device_loop_time measures.

    Every output leaf of ``fn`` is folded into the carry, so no part of a
    multi-output call can be dead-code-eliminated (tested by jaxpr
    inspection in tests/test_timing.py -- the r1-r3 DCE regression).
    """

    @jax.jit
    def loop(x, *rest):
        def body(c, _):
            out = fn(c, *rest)
            leaves = jax.tree_util.tree_leaves(out)
            first, extra = leaves[0], leaves[1:]
            # fold every other output leaf into the carry so no branch
            # of fn is dead code under jit
            sig_extra = sum(jnp.sum(l).astype(jnp.float32)
                            for l in extra) if extra else None
            if first.shape == x.shape and first.dtype == x.dtype:
                if sig_extra is None:
                    return first, None
                return first + (sig_extra * 1e-12).astype(x.dtype), None
            sig = jnp.sum(first).astype(jnp.float32)
            if sig_extra is not None:
                sig = sig + sig_extra
            # keep the carry's dtype exactly (int carries: the f32 detour
            # preserves the data dependency, the cast restores the type)
            return (c.astype(jnp.float32) + sig * 1e-12).astype(x.dtype), None

        final, _ = jax.lax.scan(body, x, None, length=length)
        return jnp.sum(final).astype(jnp.float32)

    return loop


def device_loop_time(fn: Callable, args: tuple, iters: int = 30,
                     repeats: int = 3) -> float:
    """Seconds per call of fn(*args), timed as scan-chained device programs.

    The first arg is threaded through the chain (output cast back to its
    dtype/shape via the function's own output), so each iteration
    data-depends on the previous one and cannot be elided.

    Two-point slope measurement: the loop runs at ``iters`` and ``3*iters``
    chain lengths and the per-call time is the *difference* divided by
    ``2*iters``, which cancels any constant per-dispatch cost (launch,
    transfer of the result, host scheduling).

    DCE-proof by construction (r5): EVERY output leaf of ``fn`` is folded
    into the scan carry, so a multi-output pallas call cannot have part of
    its work elided.  (The r1-r3 backward tables were voided because an
    earlier version threaded only ``out[0]``: the separate dKV pallas call
    was dead code under jit and a row benched above the matmul roofline.)
    """
    x0 = args[0]
    rest = args[1:]

    def measure(n):
        loop1 = make_timing_loop(fn, n)
        loop3 = make_timing_loop(fn, 3 * n)
        np.asarray(loop1(x0, *rest))  # compile + warm
        np.asarray(loop3(x0, *rest))
        t1 = t3 = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            np.asarray(loop1(x0, *rest))
            t1 = min(t1, time.perf_counter() - t0)
            t0 = time.perf_counter()
            np.asarray(loop3(x0, *rest))
            t3 = min(t3, time.perf_counter() - t0)
        return max(t3 - t1, 1e-9)

    # Adaptive: a slope below ~10ms of device work is drowned in host
    # jitter — rescale the chain until the signal dominates.
    MIN_SIGNAL = 10e-3
    MAX_ITERS = 50000
    delta = measure(iters)
    for _ in range(3):
        if delta >= MIN_SIGNAL or iters >= MAX_ITERS:
            break
        scale = min(int(2 * MIN_SIGNAL / max(delta, 2e-4)) + 1, 100)
        iters = min(iters * scale, MAX_ITERS)
        delta = measure(iters)
    return delta / (2 * iters)


@dataclasses.dataclass
class CaseResult:
    name: str
    shape: tuple
    custom_ms: float
    baseline_ms: float
    max_err: float

    @property
    def speedup(self) -> float:
        return self.baseline_ms / self.custom_ms


class KernelBench:
    """Register + run custom-vs-baseline cases (reference kt.init/case/run)."""

    def __init__(self, rtol: float = 1e-3, atol: float = 1e-3,
                 ntest: int = 3, iters: int = 20, seed: int = 0,
                 max_batch_tokens: int = 1024, max_seq_len: int = 512):
        self.rtol, self.atol = rtol, atol
        self.ntest, self.iters = ntest, iters
        self.rng = np.random.default_rng(seed)
        self.max_batch_tokens = max_batch_tokens
        self.max_seq_len = max_seq_len
        self.cases: Dict[str, Callable] = {}
        self.results: List[CaseResult] = []

    def bs_sl(self, batch: Optional[int] = None) -> Tuple[int, int]:
        """Random (batch_size, seq_len) draw (reference test_utils.py:28-42)."""
        if batch is None:
            batch = int(self.rng.integers(1, 9))
        seq = int(self.rng.integers(8, self.max_seq_len + 1))
        while batch * seq > self.max_batch_tokens:
            seq = max(8, seq // 2)
        return batch, seq

    def case(self, name: Optional[str] = None, rtol: Optional[float] = None,
             atol: Optional[float] = None, ntest: Optional[int] = None):
        def deco(fn):
            self.cases[name or fn.__name__] = (fn, rtol or self.rtol,
                                               atol or self.atol,
                                               ntest or self.ntest)
            return fn

        return deco

    def run(self, name: str) -> List[CaseResult]:
        fn, rtol, atol, ntest = self.cases[name]
        out = []
        for _ in range(ntest):
            custom, baseline, args = fn(self)
            ref = np.asarray(jax.jit(baseline)(*args))
            got = np.asarray(jax.jit(custom)(*args))
            err = float(np.max(np.abs(got - ref)))
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
            t_c = device_loop_time(custom, args, self.iters)
            t_b = device_loop_time(baseline, args, self.iters)
            r = CaseResult(name, tuple(args[0].shape), t_c * 1e3, t_b * 1e3, err)
            out.append(r)
            self.results.append(r)
            print(f"[{name}] shape={r.shape} custom={r.custom_ms:.3f}ms "
                  f"baseline={r.baseline_ms:.3f}ms speedup={r.speedup:.3f} "
                  f"max_err={r.max_err:.2e}")
        return out

    def run_all(self):
        for name in self.cases:
            self.run(name)
        return self.results
