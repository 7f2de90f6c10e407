"""Device-mesh construction helpers.

The reference is single-process / single-GPU with no distribution of any kind
(SURVEY.md §2.3); this module adds it: a named ``jax.sharding.Mesh`` over
which DP (batch), TP (heads/FFN) and SP (sequence/ring) axes are laid out.
The cards of one host reach each other all to all over NVLink at one rate,
so the mesh's shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def create_mesh(shape: Sequence[int], names: Sequence[str],
                devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a named mesh from the (first prod(shape)) available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(tuple(shape))
    return Mesh(arr, tuple(names))


def default_mesh(n_devices: Optional[int] = None,
                 tp_size: Optional[int] = None) -> Mesh:
    """A (data, model) mesh: TP over the minor axis, DP over the rest.

    ``tp_size`` defaults to min(n_devices, 4) rounded down to a divisor.
    """
    n = n_devices or jax.device_count()
    if tp_size is None:
        tp_size = 1
        for cand in (8, 4, 2):
            if cand <= n and n % cand == 0:
                tp_size = cand
                break
    assert n % tp_size == 0
    return create_mesh((n // tp_size, tp_size), (DATA_AXIS, MODEL_AXIS),
                       jax.devices()[:n])


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading (batch) dim of activations over ``axis``."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
