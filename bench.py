"""Headline benchmark: causal flash-attention forward on the GPU.

Mirrors the reference's own headline measurement -- naive op-graph attention
vs FlashAttention forward latency (tests/speed_test_flash_attention.py:10-87)
-- at batch 4, 8 heads, seq 2048, head_dim 128, causal, bf16.  Every route is
timed: cuDNN's fused attention, this repository's Triton kernel, and the XLA
op graph (the "naive" baseline).  A route that fails to compile or run fails
the benchmark.  Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "TFLOP/s", "vs_baseline": N, ...}

value        = TFLOP/s of the route ``impl="auto"`` takes, counting useful
               (below-diagonal) flops only;
vs_baseline  = its speedup over the XLA op graph;
routes       = every route's TFLOP/s;
roofline     = value over the card's published bf16 peak (see
               ``flashattn_tpu/utils/peaks.py``), with the power limit.

Timing: each route is chained inside ONE jitted ``lax.scan`` at two chain
lengths; the per-call time is the slope, so dispatch and sync costs cancel.
Needs a GPU: on any other backend it exits non-zero.

    python bench.py
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1

    from flashattn_tpu.ops.flash_attention import choose_impl, flash_attention
    from flashattn_tpu.utils.compile_cache import enable_compile_cache
    from flashattn_tpu.utils.peaks import card_name_and_power_limit, peaks_for
    from flashattn_tpu.utils.timing import device_loop_time

    enable_compile_cache()
    peak = peaks_for(dev.device_kind)["bf16_flops"]
    B, H, N, D = 4, 8, 2048, 128
    causal = True
    q = jax.random.normal(jax.random.PRNGKey(0), (B, H, N, D), jnp.bfloat16)
    # 2 matmuls x 2 flops, causal halves the useful work
    flops = 4 * B * H * N * N * D * (0.5 if causal else 1.0)

    tflops = {}
    for impl in ("cudnn", "triton", "reference"):
        t = device_loop_time(
            lambda x, impl=impl: flash_attention(x, x, x, causal, impl=impl),
            (q,), iters=100)
        tflops[impl] = flops / t / 1e12
    auto = choose_impl("dense", q, q, causal)
    print(json.dumps({
        "metric": f"flash_attention fwd TFLOP/s (causal bf16 B{B} H{H} N{N} "
                  f"D{D})",
        "value": round(tflops[auto], 2),
        "unit": "TFLOP/s",
        "vs_baseline": round(tflops[auto] / tflops["reference"], 3),
        "routes": {k: round(v, 2) for k, v in tflops.items()},
        "auto_route": auto,
        "roofline_share_bf16": round(tflops[auto] * 1e12 / peak, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "name_power_limit": card_name_and_power_limit()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
