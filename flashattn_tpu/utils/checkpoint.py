"""Checkpoint / resume for model + optimizer state.

The reference has NO weight checkpointing (SURVEY.md §5: only the tokenizer
and eval artifacts persist); this fills that gap with orbax, JAX's
checkpointing library (async-safe, sharding-aware on restore).
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import jax


def save_checkpoint(path: str, model: Any, opt_state: Any = None,
                    step: int = 0) -> None:
    """Write model (+ optional optimizer state) to ``path`` (a directory)."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.PyTreeCheckpointer()
    payload = {
        "model": model,
        "opt_state": opt_state,
        "step": step,
    }
    ckptr.save(path, payload, force=True)


class AsyncCheckpointManager:
    """Non-blocking checkpoint writes: training continues while the previous
    snapshot flushes to disk in a background thread (orbax
    ``AsyncCheckpointer``).  ``save`` blocks only until device buffers are
    copied to host (ms), not until files land; call ``wait`` (or rely on the
    next ``save``'s implicit barrier) before reading the files back."""

    def __init__(self):
        import orbax.checkpoint as ocp

        self._ckptr = ocp.AsyncCheckpointer(ocp.PyTreeCheckpointHandler())

    def save(self, path: str, model: Any, opt_state: Any = None,
             step: int = 0) -> None:
        self._ckptr.save(os.path.abspath(path),
                         {"model": model, "opt_state": opt_state,
                          "step": step}, force=True)

    def wait(self) -> None:
        self._ckptr.wait_until_finished()

    def close(self) -> None:
        self.wait()
        self._ckptr.close()


def restore_checkpoint(path: str, model_template: Any,
                       opt_state_template: Any = None) -> Tuple[Any, Any, int]:
    """Restore (model, opt_state, step).

    Templates provide the pytree structure/shardings (pass a freshly
    constructed model; its values are replaced by the checkpoint's).
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = ocp.PyTreeCheckpointer()
    target = {
        "model": model_template,
        "opt_state": opt_state_template,
        "step": 0,
    }
    restored = ckptr.restore(path, item=target)
    return restored["model"], restored["opt_state"], restored["step"]
