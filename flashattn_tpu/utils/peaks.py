"""Published peak rates of the accelerators this repository measures on.

Keyed by ``jax.devices()[0].device_kind``.  Source: NVIDIA's H100 data
sheet, SXM part, dense rates without sparsity, at the full 700 W power
limit.  A card set below that limit cannot hold its top clock, so every
share reported against these peaks is printed beside the card's power
limit.  A device missing from the table is an error, never a default.
"""

from __future__ import annotations

import shutil
import subprocess

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks_for(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"add them to {__name__}.PEAKS with their source")


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` as one line per card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()
