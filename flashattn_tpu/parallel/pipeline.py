"""SPMD pipeline parallelism (GPipe-style) over a named mesh axis.

Green-field capability — the reference runs its 4 transformer layers
sequentially in one process (``modules_transfomer.py:454-457``, SURVEY.md
§2.3 "Pipeline parallel: No").  The form here is *SPMD pipelining*:
every device runs the SAME program under ``shard_map``; each holds the
parameters of one pipeline stage (a contiguous slice of the layer stack),
activations flow stage-to-stage with ``jax.lax.ppermute`` around the ring,
and microbatching fills the pipeline so at steady state all stages compute
concurrently.  ``ppermute`` is AD-transposable, so ``jax.grad`` through
:func:`pipeline_apply` yields the reverse (backward) pipeline for free — no
hand-written 1F1B schedule needed for correctness.

Schedule: T = n_microbatches + n_stages - 1 rotations.  At rotation t, stage
s works on microbatch (t - s) when 0 <= t - s < M; stage 0 feeds from the
input queue, the last stage banks its output.  Bubble fraction is the usual
(S-1)/(T) — choose M >= 4*S to amortise.

Layout contract: every stage maps activations of one fixed shape to the same
shape (true for a transformer trunk).  Embedding and LM head run outside the
pipeline (replicated or TP/DP-sharded as usual).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

Array = jax.Array

STAGE_AXIS = "stage"


def stack_stage_params(stage_params: Sequence[Any]) -> Any:
    """Stack per-stage parameter pytrees along a new leading axis so the
    stage axis can be sharded over the mesh (one stage per device)."""
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs, axis=0), *stage_params)


def stage_sharding(mesh: Mesh, axis: str = STAGE_AXIS) -> NamedSharding:
    """Shard the leading (stage) axis of stacked params over ``axis``."""
    return NamedSharding(mesh, P(axis))


def pipeline_apply(
    stage_fn: Callable[[Any, Array], Array],
    stacked_params: Any,
    x: Array,
    mesh: Mesh,
    *,
    n_microbatches: int,
    axis: str = STAGE_AXIS,
    data_axis: str | None = None,
    param_specs: Any = None,
) -> Array:
    """Run ``x`` through the pipeline of stages.

    Args:
      stage_fn: ``(stage_params, activations) -> activations`` — one stage's
        computation (e.g. a scan over that stage's transformer layers).
        Activation shape/dtype must be preserved.
      stacked_params: pytree with leading stage axis (see
        :func:`stack_stage_params`), sharded one-stage-per-device over
        ``axis``.
      x: (batch, ...) activations after the (non-pipelined) embedding.
        batch must divide evenly into ``n_microbatches``.
      mesh: mesh containing ``axis`` with size = number of stages.
      n_microbatches: GPipe microbatch count M (bubble ~ (S-1)/(M+S-1)).
      data_axis: optional mesh axis sharding the *within-microbatch* batch
        dim (DP composed with PP: each stage group works on its local batch
        slice; gradient reduction over ``data_axis`` is inserted by AD/GSPMD
        in the surrounding loss).
      param_specs: optional pytree of ``PartitionSpec`` overriding the
        default ``P(axis)`` per-leaf spec — lets stage weights ALSO carry a
        tensor-parallel axis (leading dim must still be ``axis``), with
        ``stage_fn`` issuing the matching ``psum`` over that axis
        (Megatron-style TP inside each pipeline stage).

    Returns (batch, ...) activations to feed the (non-pipelined) head.
    """
    n_stages = mesh.shape[axis]
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible into "
                         f"{n_microbatches} microbatches")
    mb = batch // n_microbatches
    x_mb = x.reshape((n_microbatches, mb) + x.shape[1:])

    in_specs = (
        param_specs if param_specs is not None
        else jax.tree_util.tree_map(lambda _: P(axis), stacked_params),
        # microbatch queue: replicated over stage/model, batch-within-
        # microbatch sharded over data_axis when composing with DP
        P(None, data_axis),
    )
    out_specs = P(None, data_axis)

    # check_vma=False: stage_fn may contain pallas_call (flash attention)
    # whose out_shape carries no vma annotation — same setting as the
    # sharded-attention shims.
    @functools.partial(
        shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    def _pipeline(params, x_mb_):
        s = jax.lax.axis_index(axis)
        params_local = jax.tree_util.tree_map(lambda p: p[0], params)
        M = n_microbatches
        T = M + n_stages - 1
        fwd_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

        def rotation(t, carry):
            buf, outs = carry
            mb_idx = t - s                      # microbatch this stage holds
            active = jnp.logical_and(mb_idx >= 0, mb_idx < M)
            # stage 0 ingests microbatch t from the queue (others use buf)
            feed = jax.lax.dynamic_index_in_dim(
                x_mb_, jnp.clip(t, 0, M - 1), axis=0, keepdims=False)
            inp = jnp.where(s == 0, feed, buf)
            y = stage_fn(params_local, inp)
            y = jnp.where(active, y, jnp.zeros_like(y))
            # last stage banks its finished microbatch
            bank = jnp.logical_and(active, s == n_stages - 1)
            outs = jax.lax.dynamic_update_index_in_dim(
                outs,
                jnp.where(bank,
                          y,
                          jax.lax.dynamic_index_in_dim(
                              outs, jnp.clip(mb_idx, 0, M - 1), axis=0,
                              keepdims=False)),
                jnp.clip(mb_idx, 0, M - 1), axis=0)
            # rotate activations to the next stage around the ring
            buf = jax.lax.ppermute(y, axis, fwd_perm)
            return buf, outs

        buf0 = jnp.zeros_like(x_mb_[0])
        outs0 = jnp.zeros_like(x_mb_)
        _, outs = jax.lax.fori_loop(0, T, rotation, (buf0, outs0))
        # outs is complete only on the last stage; broadcast it to all
        # (psum of the one non-zero copy).
        outs = jnp.where(s == n_stages - 1, outs, jnp.zeros_like(outs))
        return jax.lax.psum(outs, axis)

    out = _pipeline(stacked_params, x_mb)
    return out.reshape((batch,) + x.shape[1:])


def split_layers_into_stages(layer_params: Sequence[Any],
                             n_stages: int) -> list:
    """Group a flat list of per-layer param pytrees into n_stages stacked
    groups (layers per stage = len/n_stages, stacked for lax.scan)."""
    n_layers = len(layer_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{n_stages} stages")
    per = n_layers // n_stages
    return [
        jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs, axis=0),
            *layer_params[i * per:(i + 1) * per])
        for i in range(n_stages)
    ]


def megatron_layer_fn(template: Any, model_axis: str = "model",
                      causal: bool = True) -> Callable[[Any, Array], Array]:
    """Lift a REAL ``TransformerLayer`` into a pipeline layer fn with
    Megatron tensor parallelism under manual SPMD.

    Inside :func:`pipeline_apply`'s ``shard_map`` there is no GSPMD, so the
    module's own TP shim (``apply_mesh``) cannot be used; this function
    replays the layer's forward with explicit collectives instead:

    * q/k/v projections column-parallel (each device holds its slice of
      heads; the flash kernel runs on the LOCAL heads, communication-free),
    * attention out-projection and ``ff.linear_out`` row-parallel with one
      ``psum`` over ``model_axis`` each (their replicated biases are added
      AFTER the psum so they are not multiplied by the TP degree),
    * ``ff.linear_in`` column-parallel (its bias is sharded with it),
    * layernorms replicated.

    ``template`` supplies the treedef (static config) used to rebuild the
    layer module from the TP-local parameter pytree the pipeline hands each
    stage; shard the stacked stage params with :func:`megatron_stage_specs`.
    Dropout is skipped (no per-microbatch PRNG threading) — use for eval or
    p_dropout=0 training.
    """
    treedef = jax.tree_util.tree_structure(template)

    def layer_fn(p, h):
        blk = jax.tree_util.tree_unflatten(
            treedef, jax.tree_util.tree_leaves(p))
        attn = blk.attention
        hd = attn.attn_hidden_dim

        def proj(lin, src):
            y = lin(src)                       # (B, S, local_heads * hd)
            b_, s_, ld = y.shape
            return y.reshape(b_, s_, ld // hd, hd).transpose(0, 2, 1, 3)

        a = blk.ln_1(h)
        q = proj(attn.q_projection, a)
        k = proj(attn.k_projection, a)
        v = proj(attn.v_projection, a)
        q, k = attn._rope(q, k, jnp.arange(a.shape[1], dtype=jnp.int32))
        from ..ops.flash_attention import flash_attention

        o = flash_attention(q, k, v, causal, window=attn.window)
        b_, nh, s_, _ = o.shape
        o = o.transpose(0, 2, 1, 3).reshape(b_, s_, nh * hd)
        o = jax.lax.psum(o @ attn.out_projection.weights, model_axis)
        if attn.out_projection.bias is not None:
            o = o + attn.out_projection.bias
        h = h + o

        from ..nn import functional as F

        m = blk.ln_2(h)
        u = m @ blk.ff.linear_in.weights       # column-parallel
        if blk.ff.linear_in.bias is not None:
            u = u + blk.ff.linear_in.bias      # bias sharded with the cols
        y = jax.lax.psum(F.GELU(u) @ blk.ff.linear_out.weights, model_axis)
        if blk.ff.linear_out.bias is not None:
            y = y + blk.ff.linear_out.bias
        return h + y

    return layer_fn


def megatron_stage_specs(template: Any, axis: str = STAGE_AXIS,
                         model_axis: str = "model") -> Any:
    """PartitionSpec pytree for stacked stage params of real transformer
    layers: ``P(stage, None(layers-per-stage), *tp_spec)`` per leaf, where
    the TP part follows the Megatron rules (:func:`..sharding.tp_spec_for`).
    Pass as ``pipeline_apply(param_specs=...)``."""
    from .sharding import _path_to_str, tp_spec_for

    def spec(path, leaf):
        tp = tp_spec_for(_path_to_str(path), model_axis)
        return P(axis, None, *tuple(tp))

    return jax.tree_util.tree_map_with_path(spec, template)


def scan_stage_fn(layer_fn: Callable[[Any, Array], Array]
                  ) -> Callable[[Any, Array], Array]:
    """Lift a single-layer fn into a stage fn that scans its layer stack
    (stage params carry a leading layers-per-stage axis)."""

    def stage(params, x):
        def body(h, p):
            return layer_fn(p, h), None

        out, _ = jax.lax.scan(body, x, params)
        return out

    return stage
