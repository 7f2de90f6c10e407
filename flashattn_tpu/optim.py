"""Pytree optimizers: SGD, Adam, AdamW.

JAX re-design of reference ``minitorch/optim.py`` (Optimizer:10,
Adam.step:50-79, SGD:140-151).  The reference mutates ``Parameter.value`` in
a Python loop -- one kernel launch per tensor op per parameter (SURVEY.md
§3.1).  Here an optimizer is a *pure function over the model pytree*: the
whole update is one fused XLA program, jittable together with the gradient
computation, and shards transparently under ``pjit``.

The reference's Adam second-moment bug (``(1 - beta1)`` where ``(1 - beta2)``
belongs, optim.py:68) is fixed; set ``reproduce_reference_bug=True`` to get
bit-parity with the reference for differential testing.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp


def _tree_zeros_like(tree: Any) -> Any:
    return jax.tree_util.tree_map(jnp.zeros_like, tree)


def global_norm(tree: Any) -> jax.Array:
    """L2 norm over every leaf of a gradient pytree."""
    leaves = jax.tree_util.tree_leaves(tree)
    return jnp.sqrt(sum(jnp.sum(jnp.square(l.astype(jnp.float32)))
                        for l in leaves))


def clip_by_global_norm(tree: Any, max_norm: float) -> Any:
    """Scale the whole gradient pytree so its global L2 norm <= max_norm.

    The stabiliser the reference lacks (its MT run rides an Adam whose
    second-moment bug damps steps); with a correct Adam, un-clipped training
    on the MT workload destabilises after a few epochs."""
    norm = global_norm(tree)
    scale = jnp.minimum(1.0, max_norm / jnp.maximum(norm, 1e-9))
    # Non-finite gradients (loss spike / overflow) would otherwise poison
    # every parameter permanently: skip the whole update instead.  Select
    # zeros rather than multiplying (NaN * 0 == NaN).
    finite = jnp.isfinite(norm)
    return jax.tree_util.tree_map(
        lambda l: jnp.where(finite, l * scale.astype(l.dtype),
                            jnp.zeros_like(l)), tree)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """LR schedule: linear warmup to ``peak_lr`` then cosine decay to
    ``final_frac * peak_lr``.  Pass as ``Adam(lr=warmup_cosine(...))``.

    The stabiliser half of the MT recipe (with grad clipping): constant-lr
    Adam on the MT workload spikes and NaNs after a few epochs."""

    def schedule(step):
        s = step.astype(jnp.float32) if hasattr(step, "astype") else float(step)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = jnp.clip((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + jnp.cos(jnp.pi * prog))
        return jnp.where(s < warmup_steps, warm, peak_lr * cos)

    return schedule


class SGD:
    """Plain SGD (reference optim.py:140-151)."""

    def __init__(self, lr: float = 1.0):
        self.lr = lr

    def init(self, model: Any) -> Any:
        return ()

    def step(self, model: Any, grads: Any, state: Any) -> Tuple[Any, Any]:
        new_model = jax.tree_util.tree_map(lambda p, g: p - self.lr * g, model, grads)
        return new_model, state


class AdamState(NamedTuple):
    step: jax.Array
    exp_avg: Any
    exp_avg_sq: Any


class Adam:
    """Adam with bias correction (reference optim.py:33-79 semantics).

    Matches the reference update rule exactly:
        m <- b1*m + (1-b1)*g
        v <- b2*v + (1-b2)*g^2          (reference bug uses (1-b1) here)
        denom = sqrt(v) + eps
        p <- p - lr * sqrt(1-b2^t)/(1-b1^t) * m / denom
    """

    def __init__(self, lr=1e-3, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 reproduce_reference_bug: bool = False):
        # lr: float, or a schedule ``step (int32 array) -> float array``
        # (e.g. :func:`warmup_cosine`)
        self.lr = lr
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.weight_decay = weight_decay
        self.reproduce_reference_bug = reproduce_reference_bug

    def init(self, model: Any) -> AdamState:
        return AdamState(
            step=jnp.zeros((), jnp.int32),
            exp_avg=_tree_zeros_like(model),
            exp_avg_sq=_tree_zeros_like(model),
        )

    def step(self, model: Any, grads: Any, state: AdamState) -> Tuple[Any, AdamState]:
        t = state.step + 1
        b1, b2 = self.beta1, self.beta2
        v_coef = (1.0 - b1) if self.reproduce_reference_bug else (1.0 - b2)

        if self.weight_decay:
            grads = jax.tree_util.tree_map(
                lambda g, p: g + self.weight_decay * p, grads, model
            )

        new_m = jax.tree_util.tree_map(
            lambda m, g: b1 * m + (1.0 - b1) * g, state.exp_avg, grads
        )
        new_v = jax.tree_util.tree_map(
            lambda v, g: b2 * v + v_coef * g * g, state.exp_avg_sq, grads
        )
        tf = t.astype(jnp.float32)
        bias1 = 1.0 - b1**tf
        bias2 = 1.0 - b2**tf
        lr = self.lr(t) if callable(self.lr) else self.lr
        step_size = lr * jnp.sqrt(bias2) / bias1

        new_model = jax.tree_util.tree_map(
            lambda p, m, v: p - step_size * m / (jnp.sqrt(v) + self.eps),
            model, new_m, new_v,
        )
        return new_model, AdamState(step=t, exp_avg=new_m, exp_avg_sq=new_v)


class AdamW(Adam):
    """Adam with decoupled weight decay (the production-default variant)."""

    def __init__(self, lr: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01):
        super().__init__(lr, beta1, beta2, eps, weight_decay=0.0)
        self.decoupled_weight_decay = weight_decay

    def step(self, model: Any, grads: Any, state: AdamState):
        if self.decoupled_weight_decay:
            # resolve a schedule lr at the step ABOUT to be taken (t = step+1,
            # matching Adam.step's bias-correction counter)
            lr = self.lr(state.step + 1) if callable(self.lr) else self.lr
            model = jax.tree_util.tree_map(
                lambda p: p * (1.0 - lr * self.decoupled_weight_decay), model
            )
        return super().step(model, grads, state)


class AdafactorState(NamedTuple):
    step: jax.Array
    vr: Any      # row stats (ndim>=2 leaves) / full second moment (ndim<2)
    vc: Any      # col stats (ndim>=2 leaves) / zero-size placeholder
    m: Any       # first moment tree when beta1 > 0, else None


class Adafactor:
    """Adafactor (Shazeer & Stern 2018): Adam-quality updates with the
    second moment FACTORED into row/column statistics for matrix-shaped
    parameters — optimizer memory drops from 2x params (Adam) to ~1x per
    factored dim (the classic large-model memory saver; pairs with ZeRO and remat
    in the memory ladder).

    The reference ships only Adam/SGD (minitorch/optim.py); this extends
    the optimizer tier the way quantization extends the kernel tier.

    * leaves with ndim >= 2 keep exp-decayed means of g^2 over the last
      (vr) and second-to-last (vc) axes; the update divides by
      rsqrt(vr/mean(vr)) (x) rsqrt(vc)
    * 0/1-d leaves keep a full second moment (nothing to factor)
    * decay follows the paper's schedule beta2_t = 1 - t^-0.8
    * updates are RMS-clipped at ``clip_threshold`` (d = 1.0)
    * ``relative_step=True`` uses the paper's lr: min(1e-2, 1/sqrt(t))
      scaled by max(eps2, rms(p)); otherwise ``lr`` (float or schedule)
    * ``beta1 > 0`` adds optional first-moment momentum (off by default —
      the memory-efficient configuration)
    """

    def __init__(self, lr=None, *, beta1: float = 0.0,
                 decay_exponent: float = 0.8, eps1: float = 1e-30,
                 eps2: float = 1e-3, clip_threshold: float = 1.0,
                 relative_step: bool = True, weight_decay: float = 0.0):
        if lr is None and not relative_step:
            raise ValueError("give lr or set relative_step=True")
        if lr is not None and relative_step:
            raise ValueError(
                "lr and relative_step=True are mutually exclusive — an "
                "explicit lr would be silently ignored; pass "
                "relative_step=False with lr (HF Adafactor raises too)")
        self.lr = lr
        self.beta1 = beta1
        self.decay_exponent = decay_exponent
        self.eps1 = eps1
        self.eps2 = eps2
        self.clip_threshold = clip_threshold
        self.relative_step = relative_step
        self.weight_decay = weight_decay

    def init(self, model: Any) -> AdafactorState:
        def vr_like(p):
            return jnp.zeros(p.shape[:-1] if p.ndim >= 2 else p.shape,
                             jnp.float32)

        def vc_like(p):
            return jnp.zeros(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2
                             else (0,), jnp.float32)

        return AdafactorState(
            step=jnp.zeros((), jnp.int32),
            vr=jax.tree_util.tree_map(vr_like, model),
            vc=jax.tree_util.tree_map(vc_like, model),
            # f32 like vr/vc: updates are computed in f32, so a
            # param-dtype m would flip dtype after one step and break
            # scan-carried training state
            m=(jax.tree_util.tree_map(
                lambda p: jnp.zeros(p.shape, jnp.float32), model)
               if self.beta1 > 0 else None),
        )

    def step(self, model: Any, grads: Any, state: AdafactorState):
        t = state.step + 1
        tf = t.astype(jnp.float32)
        b2t = 1.0 - tf ** (-self.decay_exponent)

        def rms(x):
            return jnp.sqrt(jnp.mean(jnp.square(x.astype(jnp.float32)))
                            + 1e-30)

        def moments(p, g, vr, vc):
            g2 = jnp.square(g.astype(jnp.float32)) + self.eps1
            if p.ndim >= 2:
                vr = b2t * vr + (1.0 - b2t) * jnp.mean(g2, axis=-1)
                vc = b2t * vc + (1.0 - b2t) * jnp.mean(g2, axis=-2)
            else:
                vr = b2t * vr + (1.0 - b2t) * g2
            return vr, vc

        def scaled_update(p, g, vr, vc):
            g = g.astype(jnp.float32)
            if p.ndim >= 2:
                red = vr / jnp.mean(vr, axis=-1, keepdims=True)
                u = (g * jax.lax.rsqrt(red)[..., None]
                     * jax.lax.rsqrt(vc)[..., None, :])
            else:
                u = g * jax.lax.rsqrt(vr)
            u = u / jnp.maximum(1.0, rms(u) / self.clip_threshold)
            if self.relative_step:
                rho = jnp.minimum(1e-2, 1.0 / jnp.sqrt(tf))
                alpha = jnp.maximum(self.eps2, rms(p)) * rho
            else:
                alpha = self.lr(t) if callable(self.lr) else self.lr
            return u * alpha

        vrs = jax.tree_util.tree_map(
            lambda p, g, vr, vc: moments(p, g, vr, vc)[0],
            model, grads, state.vr, state.vc)
        vcs = jax.tree_util.tree_map(
            lambda p, g, vr, vc: moments(p, g, vr, vc)[1],
            model, grads, state.vr, state.vc)
        updates = jax.tree_util.tree_map(scaled_update, model, grads,
                                         vrs, vcs)
        new_m = state.m
        if self.beta1 > 0:
            new_m = jax.tree_util.tree_map(
                lambda m, u: self.beta1 * m + (1.0 - self.beta1) * u,
                state.m, updates)
            updates = new_m
        new_model = jax.tree_util.tree_map(
            lambda p, u: (p * (1.0 - self.weight_decay)
                          if self.weight_decay else p) - u.astype(p.dtype),
            model, updates)
        return new_model, AdafactorState(step=t, vr=vrs, vc=vcs, m=new_m)
