"""DCE-proofing of the timing harness (the r1-r4 measurement bug).

The r1-r3 backward tables were voided because the timing chain threaded
only ``out[0]`` of a multi-output function: the pallas call feeding the
other outputs was dead code under jit and XLA deleted it (a row benched
above the matmul roofline).  ``make_timing_loop`` now folds EVERY output leaf
into the scan carry; these tests prove it by jaxpr inspection — the
second output's compute must survive tracing.
"""

import jax
import jax.numpy as jnp

from flashattn_tpu.utils.timing import device_loop_time, make_timing_loop


def _count_in_text(fn, args, name):
    return str(jax.make_jaxpr(fn)(*args)).count(name)


def test_second_output_not_elided():
    """A two-output fn's second dot_general must survive in the loop."""
    x = jnp.ones((64, 64), jnp.float32)
    w = jnp.ones((64, 64), jnp.float32)

    def one_out(a, w_):
        return a @ w_

    def two_out(a, w_):
        return a @ w_, (a * 2.0) @ w_.T

    n1 = _count_in_text(make_timing_loop(one_out, 3), (x, w), "dot_general")
    n2 = _count_in_text(make_timing_loop(two_out, 3), (x, w), "dot_general")
    assert n2 > n1, (n1, n2)


def test_tuple_and_dict_leaves_all_folded():
    """All leaves of nested outputs contribute to the carry."""
    x = jnp.ones((32, 32), jnp.float32)

    def fn(a):
        return {"o": a @ a, "aux": (jnp.sin(a) @ a, jnp.cos(a) @ a)}

    text = str(jax.make_jaxpr(make_timing_loop(fn, 2))(x))
    # three dots plus sin and cos must all survive
    assert text.count("dot_general") >= 3
    assert "sin" in text and "cos" in text


def test_shape_changing_output_folds_into_carry():
    """Output shaped unlike the carry is reduced and folded, not dropped."""
    x = jnp.ones((16, 16), jnp.float32)

    def fn(a):
        return jnp.sum(a @ a, axis=0)  # (16,) != carry shape

    text = str(jax.make_jaxpr(make_timing_loop(fn, 2))(x))
    assert "dot_general" in text


def test_device_loop_time_runs():
    """Smoke: the two-point slope returns a positive per-call time."""
    x = jnp.ones((64, 64), jnp.float32)

    def fn(a):
        return a @ a, a + 1.0

    t = device_loop_time(fn, (x,), iters=2, repeats=1)
    assert t > 0
