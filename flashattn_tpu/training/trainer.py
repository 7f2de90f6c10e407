"""Jitted training step + loss, single-chip and multi-chip.

JAX re-design of the reference's training inner loop
(``project/run_machine_translation.py``: loss_fn:164-192, train:195-237).
The reference runs hundreds of host-dispatched kernel launches per batch
(SURVEY.md §3.1 "process/device boundary"); here the whole
forward+backward+Adam update is ONE compiled XLA program, device-resident,
donated buffers, and shards over a (data, model) mesh via GSPMD + the
shard_map attention shim.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..nn import functional as F
from ..optim import clip_by_global_norm
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..parallel.sharding import apply_mesh, shard_model, sharding_tree

Array = jax.Array


def lm_loss(model: Any, tokens: Array, targets: Array,
            loss_mask: Optional[Array] = None,
            key: Optional[jax.Array] = None) -> Array:
    """Masked next-token cross entropy (reference loss_fn:164-192).

    tokens:    (B, S) int input ids
    targets:   (B, S) int labels (already shifted, like the reference's
               collate which shifts labels host-side, :143-147)
    loss_mask: (B, S) 1.0 where the position contributes (reference masks
               source tokens + padding out of the MT loss)
    """
    # f32 loss math regardless of compute dtype (bf16 logsumexp is lossy)
    logits = model(tokens, key=key).astype(jnp.float32)
    n_vocab = logits.shape[-1]
    losses = F.softmax_loss(
        logits.reshape(-1, n_vocab), targets.reshape(-1)
    ).reshape(targets.shape)
    if loss_mask is None:
        return jnp.mean(losses)
    total = jnp.sum(losses * loss_mask)
    count = jnp.maximum(jnp.sum(loss_mask), 1.0)
    return total / count


def make_moe_loss(aux_alpha: float = 0.01) -> Callable[..., Array]:
    """Masked LM loss + the Switch load-balancing auxiliary (the model's
    ``forward_with_aux`` sums it over MoE layers).  Drop-in loss_fn for
    make_train_step / make_train_scan."""

    def loss_fn(model, tokens, targets, loss_mask=None, key=None):
        logits, aux = model.forward_with_aux(tokens, key=key)
        logits = logits.astype(jnp.float32)
        n_vocab = logits.shape[-1]
        losses = F.softmax_loss(
            logits.reshape(-1, n_vocab), targets.reshape(-1)
        ).reshape(targets.shape)
        if loss_mask is None:
            ce = jnp.mean(losses)
        else:
            ce = (jnp.sum(losses * loss_mask)
                  / jnp.maximum(jnp.sum(loss_mask), 1.0))
        return ce + aux_alpha * aux

    return loss_fn


def make_distill_loss(teacher: Any = None, alpha: float = 1.0,
                      temperature: float = 1.0) -> Callable[..., Array]:
    """Sequence-level knowledge distillation loss for speculative-decoding
    drafts: KL(teacher || student) over the vocabulary at every unmasked
    position, optionally mixed with the hard-label CE (``alpha`` weights the
    KL term; ``1 - alpha`` the CE term).

    The teacher runs under ``stop_gradient`` inside the jitted step, so one
    ``make_train_scan(opt, loss_fn=make_distill_loss(target))`` trains a
    draft whose greedy argmax tracks the target's — the acceptance-rate
    objective of greedy-exact speculative decoding (serving/engine.py).
    Green-field capability (the reference has no serving tier).

    A closure-captured ``teacher`` is baked into the jitted step as an HLO
    constant — fine for small teachers, but a large one bloats the
    executable (and remote-compile setups reject >100MB programs).  Pass
    ``teacher=None`` here and supply the teacher at call time instead via
    the step factories' ``ctx`` argument:
    ``make_train_scan(...)(model, state, tok, tgt, msk, key, ctx=teacher)``.
    """

    def loss_fn(student, tokens, targets, loss_mask=None, key=None,
                ctx=None):
        t_model = ctx if ctx is not None else teacher
        assert t_model is not None, (
            "make_distill_loss: no teacher — pass one at construction or "
            "via the step's ctx argument")
        t_logits = jax.lax.stop_gradient(t_model.eval()(tokens)).astype(
            jnp.float32)
        s_logits = student(tokens, key=key).astype(jnp.float32)
        t_logp = jax.nn.log_softmax(t_logits / temperature, axis=-1)
        s_logp = jax.nn.log_softmax(s_logits / temperature, axis=-1)
        kl = jnp.sum(jnp.exp(t_logp) * (t_logp - s_logp), axis=-1)
        if alpha < 1.0:
            n_vocab = s_logits.shape[-1]
            ce = F.softmax_loss(
                s_logits.reshape(-1, n_vocab), targets.reshape(-1)
            ).reshape(targets.shape)
            per_pos = alpha * kl + (1.0 - alpha) * ce
        else:
            per_pos = kl
        if loss_mask is None:
            return jnp.mean(per_pos)
        return (jnp.sum(per_pos * loss_mask)
                / jnp.maximum(jnp.sum(loss_mask), 1.0))

    return loss_fn


def make_mixed_precision_loss(loss_fn: Callable[..., Array] = lm_loss,
                              compute_dtype=jnp.bfloat16) -> Callable[..., Array]:
    """bf16-compute / f32-master-weight training (the standard mixed recipe).

    Wraps any ``loss_fn(model, ...)``: parameters are cast to
    ``compute_dtype`` *inside* the differentiated function, so every
    forward/backward matmul runs on the bf16 tensor cores
    while ``jax.grad`` differentiates through the cast and delivers f32
    gradients against the f32 master weights — Adam moments and the update
    stay full precision.  No loss scaling needed: bf16 keeps f32's exponent
    range (unlike fp16), and the loss fns upcast logits to f32 before the
    logsumexp.  Drop-in for make_train_step / make_train_scan /
    ShardedTrainer(loss_fn=...).
    """

    def wrapped(model, tokens, targets, loss_mask=None, key=None):
        cast = jax.tree_util.tree_map(
            lambda p: (p.astype(compute_dtype)
                       if jnp.issubdtype(p.dtype, jnp.floating) else p),
            model)
        return loss_fn(cast, tokens, targets, loss_mask, key)

    return wrapped


def _call_loss(loss_fn, model, tokens, targets, loss_mask, key, ctx):
    """Invoke a loss fn, forwarding ``ctx`` only when supplied (older loss
    fns take 5 args; ctx-aware ones like make_distill_loss take 6)."""
    if ctx is None:
        return loss_fn(model, tokens, targets, loss_mask, key)
    return loss_fn(model, tokens, targets, loss_mask, key, ctx)


def make_train_step(opt: Any,
                    loss_fn: Callable[..., Array] = lm_loss,
                    donate: bool = True,
                    grad_clip: Optional[float] = None,
                    accum_steps: int = 1) -> Callable:
    """Single-chip (or GSPMD-implicit) jitted train step.

    Returns step(model, opt_state, tokens, targets, loss_mask, key, ctx=None)
    -> (model, opt_state, loss).  ``grad_clip`` applies global-norm clipping.
    ``ctx`` is an optional pytree forwarded to the loss fn as a 6th argument
    (e.g. a distillation teacher) — passing it at call time keeps its params
    out of the compiled executable (a closure-captured teacher is baked in
    as HLO constants; remote-compile setups reject >100MB programs).

    ``accum_steps > 1`` enables gradient accumulation: the batch's leading
    dim is split into ``accum_steps`` microbatches, gradients are averaged
    over a device-side ``lax.scan`` (one live microbatch of activations at
    a time), then ONE optimiser update is applied — the standard lever for
    effective batch sizes whose activations don't fit HBM, and it composes
    with remat and ZeRO (grads accumulate in the params' sharding).
    Microbatches are weighted by their loss-mask token counts, so the
    result equals the full-batch masked mean even when valid-token counts
    differ across microbatches (assumes the loss is a masked mean over
    positions, as every loss fn in this module is).
    """

    def _grads(model, tokens, targets, loss_mask, key, ctx):
        if accum_steps == 1:
            return jax.value_and_grad(lambda m: _call_loss(
                loss_fn, m, tokens, targets, loss_mask, key, ctx))(model)

        def reshape(x):
            assert x.shape[0] % accum_steps == 0, (
                f"batch {x.shape[0]} not divisible by accum_steps {accum_steps}")
            return x.reshape((accum_steps, x.shape[0] // accum_steps)
                             + x.shape[1:])

        micro = jax.tree_util.tree_map(reshape, (tokens, targets, loss_mask))
        keys = (jax.random.split(key, accum_steps) if key is not None
                else jnp.zeros((accum_steps, 2), jnp.uint32))

        def body(acc, mb):
            (tok, tgt, msk), k = mb
            k = k if key is not None else None
            loss, grads = jax.value_and_grad(lambda m: _call_loss(
                loss_fn, m, tok, tgt, msk, k, ctx))(model)
            # Weight by the microbatch's valid-token count: the loss fn
            # returns sum(l*m)/sum(m), so summing w_i * (loss_i, grads_i)
            # and dividing by sum(w) reproduces the FULL-batch masked mean
            # exactly even when mask counts differ across microbatches.
            w = (jnp.sum(msk).astype(jnp.float32) if msk is not None
                 else jnp.float32(1.0))
            loss_sum, grad_sum, w_sum = acc
            grad_sum = jax.tree_util.tree_map(
                lambda a, g: a + w * g.astype(a.dtype), grad_sum, grads)
            return (loss_sum + w * loss, grad_sum, w_sum + w), None

        zero_g = jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, jnp.float32), model)
        (loss_sum, grad_sum, w_sum), _ = jax.lax.scan(
            body, (jnp.float32(0.0), zero_g, jnp.float32(0.0)), (micro, keys))
        scale = 1.0 / jnp.maximum(w_sum, 1e-9)
        return loss_sum * scale, jax.tree_util.tree_map(
            lambda g, p: (g * scale).astype(p.dtype), grad_sum, model)

    def _step(model, opt_state, tokens, targets, loss_mask, key, ctx=None):
        loss, grads = _grads(model, tokens, targets, loss_mask, key, ctx)
        if grad_clip is not None:
            grads = clip_by_global_norm(grads, grad_clip)
        model, opt_state = opt.step(model, grads, opt_state)
        return model, opt_state, loss

    donate_argnums = (0, 1) if donate else ()
    return jax.jit(_step, donate_argnums=donate_argnums)


def make_train_scan(opt: Any,
                    loss_fn: Callable[..., Array] = lm_loss,
                    donate: bool = True,
                    grad_clip: Optional[float] = None) -> Callable:
    """Multi-step train dispatch: lax.scan over a stack of batches.

    Returns scan(model, opt_state, tokens, targets, loss_mask, key) where
    tokens/targets/loss_mask carry a leading (n_steps,) axis; runs every step
    device-side in ONE dispatch and returns (model, opt_state, losses).

    This is the host-latency amortiser: a per-step Python loop pays the
    dispatch and sync cost once per batch; scanning K steps pays it once per
    K batches.  The reference's
    train loop (run_machine_translation.py:195-237) is the opposite extreme —
    hundreds of dispatches per batch.
    """

    def _scan(model, opt_state, tokens, targets, loss_mask, key, ctx=None):
        # targets (not tokens) carries the step count: the tokens slot may be
        # a dict pytree (seq2seq src/src_lens/tgt_in), targets is always an
        # array with leading (n_steps,).
        keys = jax.random.split(key, targets.shape[0])

        def body(carry, batch):
            model, opt_state = carry
            tok, tgt, msk, k = batch
            loss, grads = jax.value_and_grad(lambda m: _call_loss(
                loss_fn, m, tok, tgt, msk, k, ctx))(model)
            if grad_clip is not None:
                grads = clip_by_global_norm(grads, grad_clip)
            model, opt_state = opt.step(model, grads, opt_state)
            return (model, opt_state), loss

        (model, opt_state), losses = jax.lax.scan(
            body, (model, opt_state), (tokens, targets, loss_mask, keys))
        return model, opt_state, losses

    donate_argnums = (0, 1) if donate else ()
    return jax.jit(_scan, donate_argnums=donate_argnums)


def make_eval_step(loss_fn: Callable[..., Array] = lm_loss) -> Callable:
    def _eval(model, tokens, targets, loss_mask):
        return loss_fn(model.eval(), tokens, targets, loss_mask, None)

    return jax.jit(_eval)


class ShardedTrainer:
    """DP x TP training over a named mesh.

    - parameters sharded per the Megatron-style TP rules (sharding.py),
    - batch sharded over the data axis,
    - attention kernel run under shard_map (heads over the model axis),
    - GSPMD inserts gradient/activation collectives; Adam state inherits the
      parameter shardings.

    ``zero=True`` additionally shards parameters + Adam moments over the
    DATA axis (GSPMD-style ZeRO/FSDP, ``fsdp_sharding_tree``): per-device
    parameter+optimizer memory drops ~dp-fold and XLA inserts the
    all-gather-before-use / reduce-scatter-grads schedule automatically —
    the train step below is unchanged.
    """

    def __init__(self, model: Any, opt: Any, mesh: Mesh,
                 data_axis: str = DATA_AXIS, model_axis: str = MODEL_AXIS,
                 loss_fn: Callable[..., Array] = lm_loss,
                 zero: bool = False, grad_clip: Optional[float] = None,
                 seed: int = 0):
        self.mesh = mesh
        self.opt = opt
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.loss_fn = loss_fn
        # scan_steps draws fresh per-dispatch keys from here when the caller
        # passes none (a fixed default key would replay identical dropout
        # masks every dispatch)
        self._scan_key = jax.random.PRNGKey(seed)

        model = apply_mesh(model, mesh, batch_axis=data_axis, head_axis=model_axis)
        if zero:
            from ..parallel.sharding import fsdp_sharding_tree

            self.model = jax.device_put(
                model, fsdp_sharding_tree(model, mesh, data_axis, model_axis))
        else:
            self.model = shard_model(model, mesh, model_axis)
        # zeros_like preserves shardings, so Adam moments inherit the
        # parameter layout with no extra annotation.
        self.opt_state = opt.init(self.model)
        self.batch_sharding = NamedSharding(mesh, P(data_axis))

        def _step(model, opt_state, tokens, targets, loss_mask, key):
            loss, grads = jax.value_and_grad(self.loss_fn)(
                model, tokens, targets, loss_mask, key
            )
            if grad_clip is not None:
                grads = clip_by_global_norm(grads, grad_clip)
            model, opt_state = opt.step(model, grads, opt_state)
            return model, opt_state, loss

        self._jit_step = jax.jit(_step, donate_argnums=(0, 1))
        # one scan implementation: reuse the generic factory (grad clipping,
        # distill ctx, shared body) instead of duplicating the loop here
        self._jit_scan = make_train_scan(opt, loss_fn=loss_fn,
                                         grad_clip=grad_clip)

    def put_batch(self, *arrays):
        return tuple(jax.device_put(a, self.batch_sharding) for a in arrays)

    def step(self, tokens, targets, loss_mask=None, key=None) -> float:
        tokens, targets = self.put_batch(tokens, targets)
        if loss_mask is not None:
            (loss_mask,) = self.put_batch(loss_mask)
        self.model, self.opt_state, loss = self._jit_step(
            self.model, self.opt_state, tokens, targets, loss_mask, key
        )
        return loss

    def scan_steps(self, tokens, targets, loss_mask=None, key=None,
                   ctx=None):
        """K train steps in ONE dispatch over the mesh: arrays carry a
        leading (n_steps,) axis, batches stay sharded over the data axis
        (spec ``P(None, data)``), and the whole lax.scan runs device-side —
        the multi-device analogue of ``make_train_scan``'s amortiser.
        Returns the (n_steps,) per-step losses.  With ``key=None`` a fresh
        key is drawn from the trainer's internal stream per call."""
        stack_sharding = NamedSharding(self.mesh, P(None, self.data_axis))
        put = lambda a: jax.device_put(a, stack_sharding)
        tokens = jax.tree_util.tree_map(put, tokens)
        targets = put(targets)
        if loss_mask is None:
            loss_mask = jnp.ones(targets.shape, jnp.float32)
        loss_mask = put(loss_mask)
        if key is None:
            self._scan_key, key = jax.random.split(self._scan_key)
        self.model, self.opt_state, losses = self._jit_scan(
            self.model, self.opt_state, tokens, targets, loss_mask, key, ctx)
        return losses
