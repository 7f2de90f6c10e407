"""Engine wall time for each paged-decode and flash route.

The serving cell of the repository: ``ContinuousBatchingEngine`` over a
``DecoderLM`` at 4L E2048 M8192 H16 D128 V16384 in bf16, 4 requests of
2048-8000 prompt tokens and 64 new tokens each, with bf16 pools and with
int8 weights + int8 KV pools.  Each configuration's engine runs once to
compile, then is timed with 1 new token (prefill) and with 64 (decode
follows), with the paged route set to the Triton kernel and to the XLA
gather (``attn_impl="triton"`` / ``"reference"``), so the kernel's gain
shows end to end.
The prompts stream through the chunked prefill (512-token extend waves, the
paged kernel) and then decode one token per step.

Run on a GPU (one process; it exits non-zero elsewhere):
    python kernel_bench/bench_serving.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import flashattn_tpu as ft  # noqa: E402
from flashattn_tpu.ops.quant import quantize_model_weights  # noqa: E402
from flashattn_tpu.serving import ContinuousBatchingEngine  # noqa: E402
from flashattn_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from flashattn_tpu.utils.peaks import card_name_and_power_limit  # noqa: E402

V, E, M, L, H = 16384, 2048, 8192, 4, 16
PROMPTS = (2048, 3500, 5600, 8000)
NEW = 64
CAP = 8192 + 128


def serve(eng, prompts, new):
    """Wall seconds of one engine run answering every prompt."""
    reqs = [eng.submit(p, new) for p in prompts]
    t0 = time.perf_counter()
    eng.run()
    dt = time.perf_counter() - t0
    assert all(len(r.generated) == new for r in reqs)
    return dt


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform}")
    enable_compile_cache()
    print(f"{dev.device_kind}, {card_name_and_power_limit()}; {L}L E{E} M{M} "
          f"H{H} V{V} bf16; prompts {PROMPTS} + {NEW} new tokens",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, V, size=n)) for n in PROMPTS]
    configs = [("bf16 weights + bf16 KV", jnp.bfloat16),
               ("int8 weights + int8 KV", jnp.int8)]
    for name, kv in configs:
        for paged in ("triton", "reference"):
            # the same weights (one seed) on each route
            model = ft.DecoderLM(V, E, H, CAP, p_dropout=0.0, n_layer=L,
                                 middle_dim=M, attn_impl=paged,
                                 key=jax.random.PRNGKey(0),
                                 dtype=jnp.bfloat16).eval()
            if kv == jnp.int8:
                model = quantize_model_weights(model, jnp.int8)
            # one engine: its jitted steps compile in the first run and are
            # reused by the timed ones
            eng = ContinuousBatchingEngine(
                model, max_batch=len(prompts), page_size=128,
                pages_per_seq=CAP // 128, dtype=kv, steps_per_dispatch=8)
            serve(eng, prompts, NEW)              # compile
            serve(eng, prompts, 1)
            t_prefill = serve(eng, prompts, 1)    # prefill + first token
            t_full = serve(eng, prompts, NEW)
            decode = (NEW - 1) * len(PROMPTS) / (t_full - t_prefill)
            print(f"{name:24s} paged {paged:9s}: prefill + first token "
                  f"{t_prefill:7.3f} s, full run {t_full:7.3f} s, decode "
                  f"{decode:7.1f} tok/s over {len(PROMPTS)} sequences",
                  flush=True)


if __name__ == "__main__":
    main()
