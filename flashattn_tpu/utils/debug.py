"""Numerical-debug utilities.

The reference *declares* a NaN/Inf checker and a 2-norm probe but never
implements them (``src/includes/cuda_util.h:41-49``: ``check_nan_inf`` /
``CHECK_NAN_INF`` / ``check_2norm``); its debugging culture is commented-out
prints (``cuda_kernel_ops.py:644-659``).  This module makes that surface real
the JAX way (SURVEY.md §5): ``checkify`` for jit-safe functional error checks,
``jax.debug.print`` for in-graph probes, and a host-side pytree sweep for
post-hoc inspection.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify

Array = jax.Array


def assert_finite(x: Array, name: str = "tensor") -> Array:
    """Jit-safe NaN/Inf check (cuda_util.h ``CHECK_NAN_INF`` role).

    Insert inside jitted code; run the function under
    :func:`checkify_errors` (or ``checkify.checkify``) to surface failures.
    Returns ``x`` unchanged so it can be threaded inline.
    """
    checkify.check(jnp.all(jnp.isfinite(x)), f"{name} contains NaN/Inf")
    return x


def checkify_errors(fn: Callable) -> Callable:
    """Wrap ``fn`` so :func:`assert_finite` checks raise on the host.

    ``checked = checkify_errors(step); checked(args)`` raises
    ``JaxRuntimeError`` if any embedded check fired — the functional
    replacement for the reference's kernel-side ``exit(EXIT_FAILURE)``
    (softmax_kernel.cu:283-286).
    """

    checked = checkify.checkify(fn, errors=checkify.user_checks)

    def run(*args, **kwargs):
        err, out = checked(*args, **kwargs)
        err.throw()
        return out

    return run


def check_2norm(x: Array, name: str = "tensor") -> Array:
    """In-graph 2-norm probe (cuda_util.h:49 ``check_2norm``): prints the
    L2 norm at trace execution time via ``jax.debug.print``; identity on x."""
    jax.debug.print(name + " 2-norm: {n}", n=jnp.linalg.norm(
        x.astype(jnp.float32).reshape(-1)))
    return x


def tensor_stats(x: Array) -> Dict[str, float]:
    """Host-side summary (min/max/mean/norm/nan count) for printf-debugging."""
    a = np.asarray(x, dtype=np.float64)
    return {
        "shape": tuple(a.shape),
        "min": float(np.nanmin(a)) if a.size else 0.0,
        "max": float(np.nanmax(a)) if a.size else 0.0,
        "mean": float(np.nanmean(a)) if a.size else 0.0,
        "l2": float(np.linalg.norm(a.reshape(-1))),
        "nan": int(np.isnan(a).sum()),
        "inf": int(np.isinf(a).sum()),
    }


def find_nonfinite(tree: Any, prefix: str = "") -> Dict[str, Dict[str, int]]:
    """Sweep a pytree (model / grads / optimizer state) on host and return
    {path: {nan, inf}} for every leaf that has any non-finite values."""
    bad: Dict[str, Dict[str, int]] = {}
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in leaves:
        if not hasattr(leaf, "dtype") or not jnp.issubdtype(
                jnp.asarray(leaf).dtype, jnp.floating):
            continue
        a = np.asarray(leaf)
        n_nan, n_inf = int(np.isnan(a).sum()), int(np.isinf(a).sum())
        if n_nan or n_inf:
            bad[prefix + jax.tree_util.keystr(path)] = {"nan": n_nan, "inf": n_inf}
    return bad


def enable_nan_debugging(enable: bool = True) -> None:
    """Global jax_debug_nans toggle — every jitted op re-checked for NaNs
    (slow; for debugging only)."""
    jax.config.update("jax_debug_nans", enable)
