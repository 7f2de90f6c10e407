"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

The capability gap the reference lacks entirely (SURVEY.md §2.3): DP batch
sharding, Megatron-style TP over heads/FFN, shard_map'd attention kernels,
and ring attention over a sequence axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import flashattn_tpu as ft
from flashattn_tpu.ops.flash_attention import flash_attention_reference
from flashattn_tpu.parallel import (
    apply_mesh,
    create_mesh,
    default_mesh,
    ring_flash_attention,
    shard_model,
    sharded_flash_attention,
    tp_spec_for,
)
from flashattn_tpu.training import ShardedTrainer, lm_loss, make_train_step


def _qkv(b, h, n, d, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(jax.random.normal(k, (b, h, n, d)) for k in ks)


def test_default_mesh_shape():
    mesh = default_mesh(8)
    assert mesh.devices.size == 8
    assert set(mesh.axis_names) == {"data", "model"}


@pytest.mark.parametrize("causal", [False, True])
def test_sharded_flash_attention_matches_oracle(causal):
    mesh = create_mesh((2, 4), ("data", "model"))
    q, k, v = _qkv(4, 8, 64, 32, seed=1)
    out = jax.jit(
        lambda q, k, v: sharded_flash_attention(
            q, k, v, causal, mesh=mesh, batch_axis="data", head_axis="model")
    )(q, k, v)
    np.testing.assert_allclose(
        out, flash_attention_reference(q, k, v, causal), atol=1e-5, rtol=1e-4
    )


def test_sharded_flash_attention_grads():
    mesh = create_mesh((2, 4), ("data", "model"))
    q, k, v = _qkv(2, 4, 32, 16, seed=2)

    def fused(q, k, v):
        return jnp.sum(sharded_flash_attention(
            q, k, v, True, mesh=mesh, batch_axis="data", head_axis="model") ** 2)

    def oracle(q, k, v):
        return jnp.sum(flash_attention_reference(q, k, v, True) ** 2)

    g = jax.jit(jax.grad(fused, argnums=(0, 1, 2)))(q, k, v)
    gr = jax.grad(oracle, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, gr):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_attention(causal):
    mesh = create_mesh((8,), ("seq",))
    q, k, v = _qkv(1, 2, 8 * 16, 16, seed=3)
    out = jax.jit(
        lambda q, k, v: ring_flash_attention(q, k, v, causal, mesh=mesh)
    )(q, k, v)
    np.testing.assert_allclose(
        out, flash_attention_reference(q, k, v, causal), atol=1e-5, rtol=1e-4
    )


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_attention_grads(causal):
    """SP training path: gradients through the ring (dK/dV accumulators
    complete a full revolution) match the dense oracle."""
    mesh = create_mesh((8,), ("seq",))
    q, k, v = _qkv(1, 2, 8 * 16, 16, seed=9)

    def ring_loss(q, k, v):
        return jnp.sum(ring_flash_attention(q, k, v, causal, mesh=mesh) ** 2)

    def dense_loss(q, k, v):
        return jnp.sum(flash_attention_reference(q, k, v, causal) ** 2)

    g = jax.jit(jax.grad(ring_loss, argnums=(0, 1, 2)))(q, k, v)
    gr = jax.grad(dense_loss, argnums=(0, 1, 2))(q, k, v)
    for a, b, name in zip(g, gr, "qkv"):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-3,
                                   err_msg=f"d{name} mismatch")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_over_tp_sharded_heads(causal):
    """VERDICT item 6: SP composed with TP — sequence ring over a mesh that
    ALSO shards heads over ``model``; values and grads match dense."""
    mesh = create_mesh((4, 2), ("seq", "model"))
    q, k, v = _qkv(1, 4, 4 * 16, 16, seed=11)

    def ring(q, k, v):
        return ring_flash_attention(q, k, v, causal, mesh=mesh,
                                    head_axis="model")

    out = jax.jit(ring)(q, k, v)
    np.testing.assert_allclose(
        out, flash_attention_reference(q, k, v, causal), atol=1e-5, rtol=1e-4)

    g = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) ** 2),
                         argnums=(0, 1, 2)))(q, k, v)
    gr = jax.grad(
        lambda q, k, v: jnp.sum(flash_attention_reference(q, k, v, causal) ** 2),
        argnums=(0, 1, 2))(q, k, v)
    for a, b, name in zip(g, gr, "qkv"):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-3,
                                   err_msg=f"d{name} mismatch")


def test_tp_rules():
    assert tp_spec_for("layers.0.attention.q_projection.weights") == P(None, "model")
    assert tp_spec_for("layers.1.attention.out_projection.weights") == P("model", None)
    assert tp_spec_for("layers.0.ff.linear_in.bias") == P("model")
    assert tp_spec_for("layers.0.ln_1.gamma") == P()
    assert tp_spec_for("lm_head.weights") == P(None, "model")


def test_tp_rules_quantized():
    # QuantizedLinear (.values/.scales) must shard like .weights — a
    # quantized serving model silently losing TP was a review finding.
    assert tp_spec_for("layers.0.attention.q_projection.values") == P(None, "model")
    assert tp_spec_for("layers.0.attention.q_projection.scales") == P(None, "model")
    assert tp_spec_for("layers.0.attention.out_projection.values") == P("model", None)
    assert tp_spec_for("layers.0.attention.out_projection.scales") == P()
    assert tp_spec_for("layers.0.ff.linear_in.values") == P(None, "model")
    assert tp_spec_for("lm_head.values") == P(None, "model")


def test_shard_quantized_model_places_params():
    from flashattn_tpu.ops.quant import quantize_model_weights

    mesh = create_mesh((2, 4), ("data", "model"))
    model = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                         attn_impl="flash", key=jax.random.PRNGKey(0))
    qmodel = quantize_model_weights(model)
    sharded = shard_model(qmodel, mesh)
    qp = sharded.layers[0].attention.q_projection
    assert qp.values.sharding.spec == P(None, "model")
    assert qp.scales.sharding.spec == P(None, "model")
    assert sharded.lm_head.values.sharding.spec == P(None, "model")


def test_apply_mesh_rejects_unshardable_kv_heads():
    # MQA (1 kv head) cannot split over a 4-way model axis: fail fast with a
    # clear message instead of a sharding-divisibility error deep in jax.
    mesh = create_mesh((2, 4), ("data", "model"))
    model = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                         n_kv_head=1, attn_impl="flash",
                         key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="n_kv_head=1"):
        apply_mesh(model, mesh)


def test_shard_model_places_params():
    mesh = create_mesh((2, 4), ("data", "model"))
    model = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                         attn_impl="flash", key=jax.random.PRNGKey(0))
    sharded = shard_model(model, mesh)
    w = sharded.layers[0].attention.q_projection.weights
    assert w.sharding.spec == P(None, "model")
    ln = sharded.layers[0].ln_1.gamma
    assert ln.sharding.spec == P()


def test_sharded_model_forward_matches_single_device():
    mesh = create_mesh((2, 4), ("data", "model"))
    model = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=2,
                         attn_impl="flash", key=jax.random.PRNGKey(1))
    idx = jax.random.randint(jax.random.PRNGKey(2), (4, 16), 0, 64)
    ref_logits = model(idx)

    meshed = apply_mesh(model, mesh)
    sharded = shard_model(meshed, mesh)
    idx_s = jax.device_put(idx, NamedSharding(mesh, P("data")))
    logits = jax.jit(lambda m, i: m(i))(sharded, idx_s)
    np.testing.assert_allclose(logits, ref_logits, atol=1e-4, rtol=1e-4)


def test_sharded_trainer_end_to_end():
    mesh = create_mesh((2, 4), ("data", "model"))
    model = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                         attn_impl="flash", key=jax.random.PRNGKey(3))
    trainer = ShardedTrainer(model, ft.Adam(lr=5e-3), mesh)
    data = jax.random.randint(jax.random.PRNGKey(4), (8, 17), 0, 64)
    tokens, targets = data[:, :-1], data[:, 1:]
    losses = [float(trainer.step(tokens, targets)) for _ in range(10)]
    assert losses[-1] < losses[0]
    # the updated params stay sharded
    assert trainer.model.layers[0].ff.linear_in.weights.sharding.spec == P(None, "model")


def test_single_chip_train_step_factory():
    model = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                         attn_impl="reference", key=jax.random.PRNGKey(5))
    opt = ft.Adam(lr=5e-3)
    step = make_train_step(opt)
    state = opt.init(model)
    data = jax.random.randint(jax.random.PRNGKey(6), (4, 17), 0, 64)
    mask = jnp.ones((4, 16))
    l0 = None
    for i in range(5):
        model, state, loss = step(model, state, data[:, :-1], data[:, 1:], mask, None)
        l0 = l0 or float(loss)
    assert float(loss) < l0


def test_train_scan_matches_sequential_steps():
    """make_train_scan (K steps in one dispatch) must equal K sequential
    make_train_step calls with the same per-step PRNG keys."""
    from flashattn_tpu.training import make_train_scan

    def build():
        m = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                         attn_impl="reference", key=jax.random.PRNGKey(5))
        opt = ft.Adam(lr=5e-3)
        return m, opt, opt.init(m)

    K = 4
    data = jax.random.randint(jax.random.PRNGKey(6), (K, 4, 17), 0, 64)
    toks, tgts = data[:, :, :-1], data[:, :, 1:]
    mask = jnp.ones((K, 4, 16))
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, K)

    m1, opt1, s1 = build()
    step = make_train_step(opt1, donate=False)
    seq_losses = []
    for i in range(K):
        m1, s1, loss = step(m1, s1, toks[i], tgts[i], mask[i], keys[i])
        seq_losses.append(float(loss))

    m2, opt2, s2 = build()
    scan = make_train_scan(opt2, donate=False)
    m2, s2, losses = scan(m2, s2, toks, tgts, mask, key)

    np.testing.assert_allclose(np.asarray(losses), np.asarray(seq_losses),
                               rtol=1e-5, atol=1e-6)
    # params agree up to XLA fusion-order noise in the Adam update
    for a, b in zip(jax.tree_util.tree_leaves(m1),
                    jax.tree_util.tree_leaves(m2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=5e-4)


def test_lm_loss_masking():
    model = ft.DecoderLM(32, 16, 2, 8, p_dropout=0.0, n_layer=1,
                         attn_impl="reference", key=jax.random.PRNGKey(7))
    toks = jax.random.randint(jax.random.PRNGKey(8), (2, 8), 0, 32)
    full = lm_loss(model, toks, toks, jnp.ones((2, 8)))
    half_mask = jnp.concatenate([jnp.ones((2, 4)), jnp.zeros((2, 4))], axis=1)
    half = lm_loss(model, toks, toks, half_mask)
    assert not np.allclose(float(full), float(half))

def test_distill_loss_trains_draft_toward_teacher():
    """make_distill_loss: a student trained on the KL objective moves its
    greedy argmax toward the teacher's (the speculative-decoding acceptance
    objective, serving/engine.py)."""
    from flashattn_tpu.training import make_distill_loss, make_train_step

    teacher = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=2,
                           attn_impl="reference", key=jax.random.PRNGKey(1))
    student = ft.DecoderLM(64, 16, 2, 16, p_dropout=0.0, n_layer=1,
                           attn_impl="reference", key=jax.random.PRNGKey(2))
    opt = ft.Adam(lr=5e-3)
    step = make_train_step(opt, loss_fn=make_distill_loss(teacher))
    state = opt.init(student)
    data = jax.random.randint(jax.random.PRNGKey(3), (8, 17), 0, 64)
    tok, tgt = data[:, :-1], data[:, 1:]

    def agreement(s):
        return float(jnp.mean(
            jnp.argmax(s(tok), -1) == jnp.argmax(teacher(tok), -1)))

    a0 = agreement(student)
    losses = []
    for i in range(30):
        student, state, loss = step(student, state, tok, tgt, None, None)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9
    assert agreement(student) > a0
    # alpha<1 mixes in hard-label CE and still runs
    mixed = make_distill_loss(teacher, alpha=0.5)
    l = mixed(student, tok, tgt, jnp.ones_like(tgt, jnp.float32), None)
    assert jnp.isfinite(l)


def test_fsdp_spec_composes_with_tp():
    from flashattn_tpu.parallel.sharding import fsdp_spec_for

    mesh = create_mesh((4, 2), ("data", "model"))
    # column-parallel weight: TP on out dim, FSDP takes the free in dim
    assert fsdp_spec_for("layers.0.ff.linear_in.weights", (64, 256), mesh) \
        == P("data", "model")
    # row-parallel weight: TP on in dim, FSDP on out dim
    assert fsdp_spec_for("layers.0.attention.out_projection.weights",
                         (256, 64), mesh) == P("model", "data")
    # replicated-by-TP large weight: FSDP picks the largest divisible dim
    assert fsdp_spec_for("some.other.weights", (128, 512), mesh) \
        == P(None, "data")
    # small params stay replicated (gather latency > HBM saving)
    assert fsdp_spec_for("layers.0.ln_1.gamma", (64,), mesh) == P()
    # indivisible dims are left alone
    assert fsdp_spec_for("odd.weights", (130, 254), mesh, min_size=1) == P()


def test_zero_trainer_shards_params_and_moments_over_data():
    mesh = create_mesh((4, 2), ("data", "model"))
    model = ft.DecoderLM(256, 128, 4, 16, p_dropout=0.0, n_layer=1,
                         attn_impl="flash", key=jax.random.PRNGKey(3))
    trainer = ShardedTrainer(model, ft.Adam(lr=5e-3), mesh, zero=True)
    w = trainer.model.layers[0].ff.linear_in.weights
    assert w.sharding.spec == P("data", "model")
    # per-device shard is dp*tp-fold smaller: ZeRO's memory claim
    assert w.addressable_shards[0].data.size == w.size // 8
    # Adam moments inherit the FSDP layout via zeros_like: every big moment
    # leaf is partitioned over the data axis
    m_leaf = jax.tree_util.tree_leaves(trainer.opt_state)
    big = [x for x in m_leaf if hasattr(x, "size") and x.size == w.size]
    assert big and all("data" in jax.tree_util.tree_leaves(tuple(x.sharding.spec))
                       for x in big)

    data = jax.random.randint(jax.random.PRNGKey(4), (8, 17), 0, 256)
    losses = [float(trainer.step(data[:, :-1], data[:, 1:]))
              for _ in range(10)]
    assert losses[-1] < losses[0]
    # updated params keep the FSDP sharding after donated jit steps
    w2 = trainer.model.layers[0].ff.linear_in.weights
    assert w2.sharding.spec == P("data", "model")


def test_zero_trainer_matches_plain_tp_losses():
    """ZeRO relayouts must not change the math: loss trajectory equals the
    plain TP trainer's to reduction-order tolerance."""
    mesh = create_mesh((4, 2), ("data", "model"))

    def build():
        return ft.DecoderLM(128, 64, 4, 16, p_dropout=0.0, n_layer=2,
                            attn_impl="flash", key=jax.random.PRNGKey(7))

    t_plain = ShardedTrainer(build(), ft.Adam(lr=5e-3), mesh)
    t_zero = ShardedTrainer(build(), ft.Adam(lr=5e-3), mesh, zero=True)
    data = jax.random.randint(jax.random.PRNGKey(8), (8, 17), 0, 128)
    for _ in range(5):
        lp = float(t_plain.step(data[:, :-1], data[:, 1:]))
        lz = float(t_zero.step(data[:, :-1], data[:, 1:]))
        assert abs(lp - lz) < 1e-4, (lp, lz)


def test_grad_accumulation_matches_full_batch():
    """accum_steps=4 over batch 8 must equal the full-batch step: same loss,
    same updated params (fp-reorder tolerance). One optimiser update either
    way -- the memory lever leaves the math unchanged."""
    def build():
        return ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                            attn_impl="reference", key=jax.random.PRNGKey(5))

    opt = ft.Adam(lr=5e-3)
    data = jax.random.randint(jax.random.PRNGKey(6), (8, 17), 0, 64)

    m_full, s_full = build(), opt.init(build())
    m_acc, s_acc = build(), opt.init(build())
    step_full = make_train_step(opt, donate=False)
    step_acc = make_train_step(opt, donate=False, accum_steps=4)
    for _ in range(3):
        m_full, s_full, l_full = step_full(
            m_full, s_full, data[:, :-1], data[:, 1:], None, None)
        m_acc, s_acc, l_acc = step_acc(
            m_acc, s_acc, data[:, :-1], data[:, 1:], None, None)
    assert abs(float(l_full) - float(l_acc)) < 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(m_full),
                    jax.tree_util.tree_leaves(m_acc)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_grad_accumulation_with_mask_and_key():
    """Masked loss + dropout keys: runs and stays finite (mean-of-means over
    microbatches is the standard accumulation semantics)."""
    model = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.1, n_layer=1,
                         attn_impl="reference", key=jax.random.PRNGKey(5))
    opt = ft.Adam(lr=5e-3)
    state = opt.init(model)
    step = make_train_step(opt, donate=False, accum_steps=2, grad_clip=1.0)
    data = jax.random.randint(jax.random.PRNGKey(6), (4, 17), 0, 64)
    mask = (jax.random.uniform(jax.random.PRNGKey(7), (4, 16)) > 0.3
            ).astype(jnp.float32)
    model, state, loss = step(model, state, data[:, :-1], data[:, 1:], mask,
                              jax.random.PRNGKey(8))
    assert jnp.isfinite(loss)


def test_mixed_precision_loss_trains_with_f32_master_weights():
    """bf16-compute/f32-master recipe: matmuls traced in bf16, params and
    Adam state stay f32, loss tracks the full-f32 trajectory closely."""
    from flashattn_tpu.training import make_mixed_precision_loss

    def build():
        return ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                            attn_impl="reference", key=jax.random.PRNGKey(5))

    opt = ft.Adam(lr=5e-3)
    data = jax.random.randint(jax.random.PRNGKey(6), (8, 17), 0, 64)
    mp_loss = make_mixed_precision_loss(lm_loss)

    # the compute graph actually runs in bf16
    jaxpr = str(jax.make_jaxpr(
        lambda m: mp_loss(m, data[:, :-1], data[:, 1:]))(build()))
    assert "bf16" in jaxpr

    m_mp, s_mp = build(), opt.init(build())
    m_fp, s_fp = build(), opt.init(build())
    step_mp = make_train_step(opt, loss_fn=mp_loss, donate=False)
    step_fp = make_train_step(opt, donate=False)
    for _ in range(10):
        m_mp, s_mp, l_mp = step_mp(
            m_mp, s_mp, data[:, :-1], data[:, 1:], None, None)
        m_fp, s_fp, l_fp = step_fp(
            m_fp, s_fp, data[:, :-1], data[:, 1:], None, None)
    # master weights never leave f32
    assert all(x.dtype == jnp.float32
               for x in jax.tree_util.tree_leaves(m_mp))
    assert all(x.dtype == jnp.float32
               for x in jax.tree_util.tree_leaves(s_mp)
               if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating))
    assert float(l_mp) < 4.0  # it actually learns
    # bf16 rounding stays a perturbation, not a divergence
    assert abs(float(l_mp) - float(l_fp)) < 0.1, (float(l_mp), float(l_fp))


def test_grad_accumulation_masked_mean_matches_full_batch():
    """Uneven mask counts across microbatches: mask-count weighting must
    reproduce the full-batch masked mean exactly (the unweighted
    mean-of-means diverges ~2x at this mask skew)."""
    def build():
        return ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                            attn_impl="reference", key=jax.random.PRNGKey(5))

    opt = ft.Adam(lr=5e-3)
    data = jax.random.randint(jax.random.PRNGKey(6), (8, 17), 0, 64)
    # first half almost fully masked out, second half fully counted
    mask = jnp.concatenate([
        jnp.zeros((4, 16)).at[:, 0].set(1.0), jnp.ones((4, 16))], axis=0)

    m_full, s_full = build(), opt.init(build())
    m_acc, s_acc = build(), opt.init(build())
    step_full = make_train_step(opt, donate=False)
    step_acc = make_train_step(opt, donate=False, accum_steps=2)
    for _ in range(3):
        m_full, s_full, l_full = step_full(
            m_full, s_full, data[:, :-1], data[:, 1:], mask, None)
        m_acc, s_acc, l_acc = step_acc(
            m_acc, s_acc, data[:, :-1], data[:, 1:], mask, None)
    assert abs(float(l_full) - float(l_acc)) < 1e-5, (float(l_full),
                                                      float(l_acc))
    for a, b in zip(jax.tree_util.tree_leaves(m_full),
                    jax.tree_util.tree_leaves(m_acc)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_distill_teacher_via_ctx_matches_closure():
    """ctx-threaded teacher (kept out of the executable) must train the
    draft identically to the closure-captured teacher."""
    from flashattn_tpu.training import make_distill_loss, make_train_scan

    teacher = ft.DecoderLM(64, 48, 4, 16, p_dropout=0.0, n_layer=2,
                           attn_impl="reference", key=jax.random.PRNGKey(0))

    def build():
        return ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                            attn_impl="reference", key=jax.random.PRNGKey(1))

    opt = ft.Adam(lr=5e-3)
    data = jax.random.randint(jax.random.PRNGKey(2), (3, 4, 17), 0, 64)
    tok, tgt = data[:, :, :-1], data[:, :, 1:]
    msk = jnp.ones(tgt.shape, jnp.float32)

    scan_closure = make_train_scan(opt, loss_fn=make_distill_loss(teacher),
                                   donate=False)
    m1, s1, l1 = scan_closure(build(), opt.init(build()), tok, tgt, msk,
                              jax.random.PRNGKey(3))
    scan_ctx = make_train_scan(opt, loss_fn=make_distill_loss(), donate=False)
    m2, s2, l2 = scan_ctx(build(), opt.init(build()), tok, tgt, msk,
                          jax.random.PRNGKey(3), teacher)
    np.testing.assert_allclose(l1, l2, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(m1),
                    jax.tree_util.tree_leaves(m2)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_sharded_trainer_scan_steps_matches_sequential():
    """K-steps-in-one-dispatch over the mesh == K sequential trainer.step
    calls (p_dropout=0 so per-step keys are inert)."""
    mesh = create_mesh((2, 4), ("data", "model"))

    def build():
        return ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1,
                            attn_impl="flash", key=jax.random.PRNGKey(3))

    t_seq = ShardedTrainer(build(), ft.Adam(lr=5e-3), mesh)
    t_scan = ShardedTrainer(build(), ft.Adam(lr=5e-3), mesh, zero=True)
    data = jax.random.randint(jax.random.PRNGKey(4), (3, 8, 17), 0, 64)
    tok, tgt = data[:, :, :-1], data[:, :, 1:]
    seq_losses = [float(t_seq.step(tok[i], tgt[i])) for i in range(3)]
    scan_losses = np.asarray(t_scan.scan_steps(tok, tgt))
    np.testing.assert_allclose(seq_losses, scan_losses, atol=1e-5, rtol=1e-5)
    # params agree after the same 3 updates (ZeRO relayout included)
    for a, b in zip(jax.tree_util.tree_leaves(t_seq.model),
                    jax.tree_util.tree_leaves(t_scan.model)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_sequence_parallel_model_training(pos):
    """Full-model SP: apply_mesh(seq_axis=...) routes every layer's
    attention through the differentiable ring; loss and grads match the
    unsharded model (long-context training path)."""
    from flashattn_tpu.training import lm_loss

    seq_mesh = create_mesh((8,), ("seq",))

    def build():
        return ft.DecoderLM(64, 32, 4, 128, p_dropout=0.0, n_layer=2,
                            attn_impl="flash", pos_encoding=pos,
                            key=jax.random.PRNGKey(3))

    plain = build()
    sp = apply_mesh(build(), seq_mesh, batch_axis=None, head_axis=None,
                    seq_axis="seq")
    data = jax.random.randint(jax.random.PRNGKey(4), (2, 129), 0, 64)
    tok, tgt = data[:, :-1], data[:, 1:]

    l_plain, g_plain = jax.value_and_grad(lm_loss)(plain, tok, tgt)
    l_sp, g_sp = jax.jit(jax.value_and_grad(lm_loss))(sp, tok, tgt)
    np.testing.assert_allclose(float(l_plain), float(l_sp), atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g_plain),
                    jax.tree_util.tree_leaves(g_sp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-4, rtol=1e-3)
