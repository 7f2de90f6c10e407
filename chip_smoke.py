#!/usr/bin/env python3
"""Smoke test of the system on one NVIDIA GPU: the main path, end to end.

    python3 chip_smoke.py          # one card
    python3 chip_smoke.py --four   # the multi-card path on four cards

Phases (each raises on failure; the process exits non-zero):

  0. the card: its name and power limit, JAX's version, ``XLA_FLAGS`` and
     the compile cache; then the tests marked ``gpu`` (in a child process,
     before this one opens the card); then this process must find a GPU.
  1. every kept kernel route against the plain reference at real widths:
     flash attention (Triton and cuDNN, forward and gradient; GQA, window,
     varlen, lse and the blockwise backward), paged decode (bf16, int8 and
     fp8 pages), the int8 weight-only matmul.
  2. kernel against XLA: device time per call, from chains of calls in
     one program (two-point slope, so dispatch and sync costs cancel),
     printed in pairs.
  3. train: 5 steps of ``DecoderLM`` at 4L E2048 M8192 H16 D128 V16384,
     batch 8 x 2048, bf16-mixed with remat, on a repeated batch.
  4. serve: ``ContinuousBatchingEngine`` at the same width answers 4
     requests of 2K-8K prompt tokens and 32 new tokens, with bf16 pools and
     then with int8 weights and int8 KV; the logits at every position match
     a dense forward over the same tokens.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The main path's width (the largest the repository uses).
V, E, M, L, H, D = 16384, 2048, 8192, 4, 16, 128
TRAIN_B, TRAIN_S = 8, 2048
SERVE_PROMPTS = (2048, 3500, 5600, 8000)
SERVE_NEW = 32
SERVE_CAP = 8192
PAGED_HIST = 8192

# Limits: max |got - want| <= TOL x max |want|, with no floor, so a limit is
# a few rounding steps of the largest output.  A bf16 output's rounding step
# is 2^-8 to 2^-7 of its magnitude, and the H100 readings these were set
# from (PERF.md) sit at one step: attention and its gradients 2.6e-3 to
# 6.8e-3 x max, paged decode 5.7e-3 x max (4.883e-4 at max 8.545e-2),
# engine logits 7.212e-3 x max in both serving configurations.
BF16_TOL = 2e-2
# TF32 dots (10-bit mantissa) on f32 inputs: read 3.4e-4 to 7.9e-4 x max
TF32_TOL = 3e-3
# int8 weights, K2048 accumulated in f32: read 2.7e-3 and 3.0e-3 x max
INT8_WO_TOL = 1e-2


def log(*a):
    print(*a, flush=True)


def run_gpu_tests():
    """The tests marked ``gpu``, in a child process that exits before this
    process opens the card (one JAX process per card)."""
    env = dict(os.environ, FLASHATTN_TEST_GPU="1")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(HERE, "tests")],
        cwd=HERE, env=env, timeout=900)
    if r.returncode != 0:
        raise SystemExit(f"tests marked gpu failed (rc {r.returncode})")


def require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {dev.platform} "
                         f"({dev.device_kind})")
    return jax


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def rel_err(got, want):
    import numpy as np

    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if not np.isfinite(got).all():
        return float("inf"), float(np.max(np.abs(want)))
    return float(np.max(np.abs(got - want))), float(np.max(np.abs(want)))


def check(name, got, want, tol):
    """max |got - want| <= tol * max |want|."""
    err, scale = rel_err(got, want)
    ok = err <= tol * scale
    log(f"  {'ok  ' if ok else 'FAIL'} {name}: max abs err {err:.3e} "
        f"= {err / scale:.3e} x ref max {scale:.3e} (tol {tol:g} x ref max)")
    if not ok:
        raise AssertionError(f"{name}: error {err} over tolerance")


def attention_inputs(b, h, h_kv, n, dtype, seed=0):
    import jax

    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    q = jax.random.normal(ks[0], (b, h, n, D), dtype)
    k = jax.random.normal(ks[1], (b, h_kv, n, D), dtype)
    v = jax.random.normal(ks[2], (b, h_kv, n, D), dtype)
    dy = jax.random.normal(ks[3], (b, h, n, D), dtype)
    return q, k, v, dy


ATTN_CASES = [
    # name, (b, h, h_kv, n), causal, window, ragged lengths, check grads
    ("dense causal B8 H16 N2048", (8, 16, 16, 2048), True, None, None, True),
    ("GQA H16/KV4 B2 N4096", (2, 16, 4, 4096), True, None, None, True),
    ("window 1024 B2 N4096", (2, 16, 16, 4096), True, 1024, None, True),
    ("varlen prefill B2 N8192", (2, 16, 16, 8192), True, None, (8192, 5000),
     False),
    ("varlen B2 N2048", (2, 16, 16, 2048), True, None, (2048, 700), True),
    ("varlen empty row B2 N2048", (2, 16, 16, 2048), True, None, (2048, 0),
     False),
    ("varlen window 1024 B2 N4096", (2, 16, 16, 4096), True, 1024,
     (4096, 1500), False),
]


def attention_fns(route, causal, window, lengths):
    """(forward, value-and-grad) of one attention route."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.ops import flash_attention as fa

    def fwd(q, k, v):
        if route == "f32-reference":
            with jax.default_matmul_precision("highest"):
                return fa.flash_attention_reference(
                    q.astype(jnp.float32), k.astype(jnp.float32),
                    v.astype(jnp.float32), causal, kv_lengths=lengths,
                    window=window)
        if lengths is not None:
            return fa.flash_attention_varlen(q, k, v, lengths, causal,
                                             impl=route, window=window)
        return fa.flash_attention(q, k, v, causal, impl=route, window=window)

    def grads(q, k, v, dy):
        return jax.grad(lambda a, b, c: jnp.sum(
            fwd(a, b, c).astype(jnp.float32) * dy.astype(jnp.float32)),
            argnums=(0, 1, 2))(q, k, v)

    return jax.jit(fwd), jax.jit(grads)


ATTN_ROUTES = ("cudnn", "triton", "reference")
# (b, h, n) of the f32 timing pair
F32_TIMED = (4, 16, 2048)


def attn_flops(b, h, n, causal, window):
    span = n if not causal else (n / 2 if window is None else min(window, n))
    return 4.0 * b * h * n * span * D


# ---------------------------------------------------------------------------
# phase 1 and 2: routes against the reference, then against XLA
# ---------------------------------------------------------------------------


def phase_attention(jax, times):
    import jax.numpy as jnp

    from flashattn_tpu.utils.timing import device_loop_time

    from flashattn_tpu.ops import flash_attention as fa

    log("phase 1/2: flash attention routes (bf16 inputs; reference f32 "
        "with matmul precision highest)")
    for name, (b, h, h_kv, n), causal, window, ragged, grads in ATTN_CASES:
        q, k, v, dy = attention_inputs(b, h, h_kv, n, jnp.bfloat16)
        lengths = None if ragged is None else jnp.asarray(ragged, jnp.int32)
        ref_f, ref_g = attention_fns("f32-reference", causal, window, lengths)
        want = ref_f(q, k, v)
        want_g = ref_g(q, k, v, dy) if grads else None
        del ref_g
        fl = attn_flops(b, h, n, causal, window)
        for route in ATTN_ROUTES:
            f, g = attention_fns(route, causal, window, lengths)
            check(f"{name} {route} fwd", f(q, k, v), want, BF16_TOL)
            if want_g is not None:
                got_g = g(q, k, v, dy)
                for nm, a, w in zip("qkv", got_g, want_g):
                    check(f"{name} {route} d{nm}", a, w, BF16_TOL)
            tf = device_loop_time(f, (q, k, v))
            tg = device_loop_time(g, (q, k, v, dy))
            times.append((f"attn {name} {route} fwd, fwd+bwd", tf, tg))
            log(f"  time {name} {route}: fwd {tf*1e3:.3f} ms "
                f"({fl/tf/1e12:.1f} TF/s), fwd+bwd {tg*1e3:.3f} ms "
                f"({3.5*fl/tg/1e12:.1f} TF/s)")
        del want, want_g

    # f32 through the Triton route (tensor-core TF32, Triton's default),
    # timed against the XLA op graph at XLA's default f32 precision
    q, k, v, dy = attention_inputs(2, 8, 8, 1024, jnp.float32, seed=3)
    ref_f, ref_g = attention_fns("f32-reference", True, None, None)
    f, g = attention_fns("triton", True, None, None)
    check("f32 B2 H8 N1024 triton (TF32) fwd", f(q, k, v), ref_f(q, k, v),
          TF32_TOL)
    for nm, a, w in zip("qkv", g(q, k, v, dy), ref_g(q, k, v, dy)):
        check(f"f32 B2 H8 N1024 triton (TF32) d{nm}", a, w, TF32_TOL)
    b, h, n = F32_TIMED
    q, k, v, dy = attention_inputs(b, h, h, n, jnp.float32, seed=5)
    fl = attn_flops(b, h, n, True, None)
    for route in ("triton", "reference"):
        f, g = attention_fns(route, True, None, None)
        tf = device_loop_time(f, (q, k, v))
        tg = device_loop_time(g, (q, k, v, dy))
        times.append((f"attn f32 B{b} H{h} N{n} {route} fwd, fwd+bwd", tf,
                      tg))
        log(f"  time f32 B{b} H{h} N{n} {route}: fwd {tf*1e3:.3f} ms "
            f"({fl/tf/1e12:.1f} TF/s), fwd+bwd {tg*1e3:.3f} ms "
            f"({3.5*fl/tg/1e12:.1f} TF/s)")

    # lse and the blockwise backward that ring attention runs
    q, k, v, dy = attention_inputs(2, 16, 4, 2048, jnp.bfloat16, seed=4)
    with jax.default_matmul_precision("highest"):
        o32, lse32 = fa._reference_fwd_with_lse(
            *(t.astype(jnp.float32) for t in (q, k, v)), True, D ** -0.5)
    o, lse = jax.jit(lambda a, b_, c: fa.flash_attention_with_lse(
        a, b_, c, True, impl="triton"))(q, k, v)
    check("with_lse triton o", o, o32, BF16_TOL)
    check("with_lse triton lse", lse, lse32, BF16_TOL)
    bwd = jax.jit(lambda *a: fa.flash_attention_bwd(*a, True, impl="triton"))
    with jax.default_matmul_precision("highest"):
        want = fa.flash_attention_bwd(
            *(t.astype(jnp.float32) for t in (q, k, v, o32)), lse32,
            dy.astype(jnp.float32), True, impl="reference")
    for nm, a, w in zip("qkv", bwd(q, k, v, o, lse, dy), want):
        check(f"blockwise bwd triton d{nm}", a, w, BF16_TOL)


def paged_inputs(jax, b, hist, h_kv, dtype):
    """A shuffled page pool holding ``hist`` tokens per sequence, its table,
    decode queries and lengths.  Sequence 0 stops 77 tokens short of its
    last page, so the kernel loads that masked tail and must skip it; the
    tail is scaled by 8, so reading any of it would dominate the softmax."""
    import jax.numpy as jnp
    import numpy as np

    from flashattn_tpu.models.transformer import _quantize_kv

    page, tail = 128, 77
    pps = hist // page
    n_pages = b * pps
    ks = jax.random.split(jax.random.PRNGKey(b), 2)
    kf = jax.random.normal(ks[0], (h_kv, n_pages, page, D), jnp.bfloat16)
    vf = jax.random.normal(ks[1], (h_kv, n_pages, page, D), jnp.bfloat16)
    table = np.random.default_rng(b).permutation(n_pages)
    table = jnp.asarray(table.reshape(b, pps), jnp.int32)
    last = table[0, -1]
    kf = kf.at[:, last, page - tail:].multiply(8)
    vf = vf.at[:, last, page - tail:].multiply(8)
    q = jax.random.normal(jax.random.PRNGKey(9), (b, H, D), jnp.bfloat16)
    lengths = jnp.full((b,), hist, jnp.int32).at[0].set(hist - tail)
    if dtype == jnp.bfloat16:
        return kf, vf, {}, table, q, lengths
    kq, ksc = _quantize_kv(kf, dtype)
    vq, vsc = _quantize_kv(vf, dtype)
    return kq, vq, dict(k_scales=ksc, v_scales=vsc), table, q, lengths


def phase_paged(jax, times):
    import jax.numpy as jnp

    from flashattn_tpu.utils.peaks import peaks_for
    from flashattn_tpu.utils.timing import device_loop_time

    from flashattn_tpu.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    log("phase 1/2: paged decode, 8K history, H16/KV4, page 128 "
        "(reference: the XLA gather in f32)")
    hist, h_kv = PAGED_HIST, 4
    hbm = peaks_for(jax.devices()[0].device_kind)["hbm_bytes_per_s"]
    for b in (4, 16):
        for dtype in (jnp.bfloat16, jnp.int8, jnp.float8_e4m3fn):
            kp, vp, sc, table, q, lengths = paged_inputs(jax, b, hist, h_kv,
                                                         dtype)
            name = f"paged B{b} {jnp.dtype(dtype).name}"
            ker = jax.jit(lambda *a: paged_attention(*a, impl="triton", **sc))
            xla = jax.jit(lambda *a: paged_attention(*a, impl="reference",
                                                     **sc))
            args = (q, kp, vp, lengths, table)
            # the reference: pages dequantised exactly as stored
            check(name + " triton", ker(*args),
                  paged_attention_reference(*args, **sc), BF16_TOL)
            tk = device_loop_time(ker, args, iters=200)
            tx = device_loop_time(xla, args, iters=200)
            nbytes = 2 * b * h_kv * hist * D * jnp.dtype(dtype).itemsize
            if sc:
                nbytes += 2 * b * h_kv * hist * 4
            times.append((name + " triton vs xla", tk, tx))
            log(f"  time {name}: triton {tk*1e6:.1f} us "
                f"({nbytes/tk/1e9:.0f} GB/s of pages, {nbytes/tk/hbm:.0%} of "
                f"the card's {hbm/1e12:.2f} TB/s) | xla gather "
                f"{tx*1e6:.1f} us ({nbytes/tx/1e9:.0f} GB/s)")


def phase_small_ops(jax, times):
    import jax.numpy as jnp

    from flashattn_tpu.utils.timing import device_loop_time

    from flashattn_tpu.ops.layernorm import layernorm
    from flashattn_tpu.ops.dropout import fused_dropout_res_bias
    from flashattn_tpu.ops.quant import int8_weight_only_matmul, quantize_int8

    log("phase 1/2: int8 weight-only matmul, K2048 N8192 (XLA route)")
    w = jax.random.normal(jax.random.PRNGKey(0), (E, M), jnp.bfloat16)
    wq = quantize_int8(w, axis=0)
    wdq = wq.dequantize(jnp.bfloat16)
    for rows in (4, TRAIN_B * TRAIN_S):
        x = jax.random.normal(jax.random.PRNGKey(1), (rows, E), jnp.bfloat16)
        q8 = jax.jit(int8_weight_only_matmul)
        bf = jax.jit(lambda a, b_: jnp.dot(a, b_,
                                           preferred_element_type=jnp.float32))
        with jax.default_matmul_precision("highest"):
            want = jnp.dot(x.astype(jnp.float32), wdq.astype(jnp.float32))
        check(f"int8 weight-only M{rows}", q8(x, wq), want, INT8_WO_TOL)
        t8 = device_loop_time(q8, (x, wq), iters=200)
        tb = device_loop_time(bf, (x, w), iters=200)
        times.append((f"int8-wo M{rows} vs bf16", t8, tb))
        log(f"  time M{rows}: int8 weight-only {t8*1e6:.1f} us | bf16 "
            f"matmul {tb*1e6:.1f} us")

    log("phase 2: LayerNorm and dropout+bias+residual as XLA fuses them, "
        f"({TRAIN_B * TRAIN_S}, {E}) bf16")
    x = jax.random.normal(jax.random.PRNGKey(2), (TRAIN_B * TRAIN_S, E),
                          jnp.bfloat16)
    g = jnp.ones((E,), jnp.bfloat16)
    nbytes = 2 * x.size * 2
    ln = jax.jit(lambda a: layernorm(a, g, g))
    t_ln = device_loop_time(ln, (x,), iters=200)
    log(f"  layernorm fwd (XLA): {t_ln*1e6:.1f} us, {nbytes/t_ln/1e9:.0f} "
        "GB/s")
    try:
        from jax.experimental.pallas.ops.gpu import layer_norm as lib_ln

        tri = jax.jit(lambda a: lib_ln.layer_norm(a[None], g, g)[0])
        check("library Triton layer_norm vs XLA", tri(x), ln(x), BF16_TOL)
        t_tri = device_loop_time(tri, (x,), iters=200)
        log(f"  layernorm fwd (JAX's library Triton kernel): "
            f"{t_tri*1e6:.1f} us, {nbytes/t_tri/1e9:.0f} GB/s")
        times.append(("layernorm library-triton vs xla", t_tri, t_ln))
    except ImportError as e:  # the library module is optional in JAX
        log(f"  library Triton layer_norm unavailable: {e}")
    key = jax.random.PRNGKey(3)
    drop = jax.jit(lambda a, r: fused_dropout_res_bias(a, g, r, 0.1, key))
    t_dr = device_loop_time(drop, (x, x), iters=200)
    log(f"  dropout+bias+residual (XLA): {t_dr*1e6:.1f} us, "
        f"{3*x.size*2/t_dr/1e9:.0f} GB/s (2 reads + 1 write)")


# ---------------------------------------------------------------------------
# phase 3: train
# ---------------------------------------------------------------------------


def phase_train(jax):
    import jax.numpy as jnp
    import numpy as np

    import flashattn_tpu as ft
    from flashattn_tpu.training import (lm_loss, make_mixed_precision_loss,
                                        make_train_scan)

    n = 5
    log(f"phase 3: train {L}L E{E} M{M} H{H} D{D} V{V}, batch {TRAIN_B} x "
        f"{TRAIN_S}, bf16-mixed + remat, {n} steps on one repeated batch")
    model = ft.DecoderLM(V, E, H, TRAIN_S, p_dropout=0.0, n_layer=L,
                         middle_dim=M, remat=True, key=jax.random.PRNGKey(0))
    opt = ft.Adam(lr=1e-3)
    state = opt.init(model)
    tok = jax.random.randint(jax.random.PRNGKey(1), (TRAIN_B, TRAIN_S + 1),
                             0, V)
    stack = lambda a: jnp.broadcast_to(a[None], (n,) + a.shape)  # noqa: E731
    args = (stack(tok[:, :-1]), stack(tok[:, 1:]),
            jnp.ones((n, TRAIN_B, TRAIN_S), jnp.float32))
    scan = make_train_scan(opt, make_mixed_precision_loss(lm_loss))
    mem = scan.lower(model, state, *args, jax.random.PRNGKey(2)).compile() \
        .memory_analysis()
    t0 = time.perf_counter()
    model, state, losses = scan(model, state, *args, jax.random.PRNGKey(2))
    losses = np.asarray(losses)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, state, more = scan(model, state, *args, jax.random.PRNGKey(3))
    jax.block_until_ready(more)
    step = (time.perf_counter() - t0) / n
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    step_bytes = (mem.temp_size_in_bytes + mem.argument_size_in_bytes
                  + mem.output_size_in_bytes - mem.alias_size_in_bytes
                  if mem is not None else 0)
    log(f"  losses {[round(float(x), 4) for x in losses]}; first call "
        f"{t_first:.1f} s (compile included); warm step {step*1e3:.1f} ms "
        f"({TRAIN_B*TRAIN_S/step:.0f} tok/s); the compiled {n}-step scan "
        f"needs {step_bytes/2**30:.2f} GiB; peak_bytes_in_use of the process "
        f"so far (phases 1-3) {peak/2**30:.2f} GiB")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite training loss")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not fall on a repeated batch")


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------


def phase_serve(jax):
    import jax.numpy as jnp
    import numpy as np

    import flashattn_tpu as ft
    from flashattn_tpu.ops.quant import quantize_model_weights
    from flashattn_tpu.serving import ContinuousBatchingEngine

    log(f"phase 4: serve {L}L E{E} M{M} H{H} D{D} V{V} in bf16, 4 requests "
        f"of {SERVE_PROMPTS} prompt tokens + {SERVE_NEW} new")
    model = ft.DecoderLM(V, E, H, SERVE_CAP, p_dropout=0.0, n_layer=L,
                         middle_dim=M, key=jax.random.PRNGKey(5),
                         dtype=jnp.bfloat16).eval()
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, V, size=n)) for n in SERVE_PROMPTS]
    configs = [
        # batched prefill through flash_attention_varlen
        ("bf16 weights + bf16 KV", model, jnp.bfloat16, SERVE_CAP),
        # chunked prefill through the paged kernel's extend path
        ("int8 weights + int8 KV", quantize_model_weights(model, jnp.int8),
         jnp.int8, 512),
    ]
    dense = jax.jit(lambda m, t: m(t))
    failed = []
    for name, m, kv_dtype, prefill_chunk in configs:
        eng = ContinuousBatchingEngine(
            m, max_batch=4, page_size=128, pages_per_seq=SERVE_CAP // 128,
            dtype=kv_dtype, collect_logits=True, prefill_chunk=prefill_chunk)
        reqs = [eng.submit(p, SERVE_NEW) for p in prompts]
        t0 = time.perf_counter()
        eng.run()
        t_run = time.perf_counter() - t0
        seqs = np.zeros((4, SERVE_CAP), np.int32)
        for i, r in enumerate(reqs):
            if len(r.generated) != SERVE_NEW:
                raise AssertionError(f"{name}: request {i} generated "
                                     f"{len(r.generated)} tokens")
            toks = prompts[i] + r.generated[:-1]
            seqs[i, :len(toks)] = toks
        want = np.asarray(dense(m, jnp.asarray(seqs)).astype(jnp.float32))
        worst = 0.0
        for i, r in enumerate(reqs):
            got = np.stack(r.logits).astype(np.float32)
            err, scale = rel_err(got, want[i, :len(got)])
            worst = max(worst, err / scale)
        ok = worst <= BF16_TOL
        log(f"  {'ok  ' if ok else 'FAIL'} {name}: engine logits at every "
            f"prompt and generated position vs dense forward: max abs err / "
            f"max |logit| = {worst:.3e} (tol {BF16_TOL:g}); engine run "
            f"{t_run:.1f} s, compile included")
        if not ok:
            failed.append(name)
        del eng
    if failed:
        raise AssertionError(f"engine logits off the dense forward: {failed}")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def four(jax):
    sys.path.insert(0, HERE)
    import __graft_entry__

    n = len(jax.devices())
    if n != 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX found {n}")
    log("four cards: DP x TP, ZeRO, ring SP, EP MoE and TP serving, each "
        "compared with the same computation on one device")
    __graft_entry__.dryrun_multichip(4)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card path and its comparisons only")
    args = ap.parse_args()

    from flashattn_tpu.utils.peaks import card_name_and_power_limit

    try:
        card = card_name_and_power_limit()
    except (RuntimeError, subprocess.SubprocessError) as e:
        raise SystemExit(f"chip_smoke needs an NVIDIA GPU: {e}")
    log("card:", card)
    if not args.four:
        log("phase 0: tests marked gpu")
        run_gpu_tests()
    jax = require_gpu()
    from flashattn_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    dev = jax.devices()[0]
    log(f"phase 0: {dev.platform} {dev.device_kind} x {len(jax.devices())}; "
        f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; compile cache {cache}")
    t0 = time.perf_counter()
    if args.four:
        four(jax)
    else:
        times = []
        phase_attention(jax, times)
        phase_paged(jax, times)
        phase_small_ops(jax, times)
        log("phase 2 summary (seconds; first, second):")
        for row in times:
            log(f"  {row[0]}: {row[1]:.6e} {row[2]:.6e}")
        phase_train(jax)
        phase_serve(jax)
    log(f"all phases passed in {time.perf_counter() - t0:.0f} s")
    log("card:", card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
