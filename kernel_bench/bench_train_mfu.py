"""Train-step time and model-FLOP utilisation for each attention route.

The training cell of the repository: ``DecoderLM`` at 4L E2048 M8192 H16
D128 V16384, batch 8 x 2048, bf16-mixed compute over f32 master weights with
remat, ``make_train_scan``.  The same step runs with every attention route
(``attn_impl``): cuDNN, the Triton kernels and the XLA op graph, so a
kernel's gain or loss shows end to end.

FLOP accounting (recomputed flops excluded):
  matmul-weight flops = 6 * W * tokens          (2 fwd + 4 bwd per MAC)
      W = n_layer * (4 E^2 + 2 E M) + E V       (qkv/out + MLP + lm_head)
  attention flops     = n_layer * B * H * (S^2/2) * D * 2 * (2 fwd + 5 bwd)
MFU = flops per step / step time / the card's published bf16 peak
(``flashattn_tpu/utils/peaks.py``), printed beside its power limit.

Run on a GPU (one process; it exits non-zero elsewhere):
    python kernel_bench/bench_train_mfu.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import flashattn_tpu as ft  # noqa: E402
from flashattn_tpu.training import (lm_loss, make_mixed_precision_loss,  # noqa: E402
                                    make_train_scan)
from flashattn_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from flashattn_tpu.utils.peaks import card_name_and_power_limit, peaks_for  # noqa: E402

V, E, M, L, H, B, S = 16384, 2048, 8192, 4, 16, 8, 2048
STEPS = 3


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform}")
    enable_compile_cache()
    peak = peaks_for(dev.device_kind)["bf16_flops"]
    D = E // H
    W = L * (4 * E * E + 2 * E * M) + E * V
    flops = 6 * W * B * S + L * B * H * (S * S / 2) * D * 2 * 7
    print(f"{dev.device_kind}, {card_name_and_power_limit()}; {L}L E{E} M{M} "
          f"H{H} D{D} V{V}, batch {B} x {S}, bf16-mixed + remat; "
          f"{flops / 1e12:.2f} model TFLOP/step", flush=True)

    tok = jax.random.randint(jax.random.PRNGKey(1), (B, S + 1), 0, V)
    stack = lambda a: jnp.broadcast_to(a[None], (STEPS,) + a.shape)  # noqa: E731
    args = (stack(tok[:, :-1]), stack(tok[:, 1:]),
            jnp.ones((STEPS, B, S), jnp.float32))
    opt = ft.Adam(lr=1e-4)
    for route in ("cudnn", "triton", "reference"):
        model = ft.DecoderLM(V, E, H, S, p_dropout=0.0, n_layer=L,
                             middle_dim=M, remat=True, attn_impl=route,
                             key=jax.random.PRNGKey(0))
        state = opt.init(model)
        scan = make_train_scan(opt, make_mixed_precision_loss(lm_loss))
        model, state, losses = scan(model, state, *args,
                                    jax.random.PRNGKey(2))
        jax.block_until_ready(losses)
        times = []
        for r in range(3):
            t0 = time.perf_counter()
            model, state, losses = scan(model, state, *args,
                                        jax.random.PRNGKey(3 + r))
            jax.block_until_ready(losses)
            times.append((time.perf_counter() - t0) / STEPS)
        step = float(np.median(times))
        peak_mem = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
        print(f"flash route {route:9s}: {step * 1e3:8.2f} ms/step  "
              f"{B * S / step:9.0f} tok/s  {flops / step / 1e12:6.1f} TF/s  "
              f"MFU {flops / step / peak * 100:5.1f}%  last loss "
              f"{float(losses[-1]):.4f}  peak {peak_mem / 2**30:.1f} GiB",
              flush=True)
        del model, state, scan


if __name__ == "__main__":
    main()
