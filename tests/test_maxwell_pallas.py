"""Stacked (folded-plane) Maxwell operator vs the flat reference operator
and the scipy assembly, and the Lanczos/FDTD methods on its state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lanczos_tpu.methods.block_lanczos import block_lanczos
from lanczos_tpu.methods.vector_lanczos import vector_lanczos
from lanczos_tpu.models.maxwell import MaxwellOperator, assemble_maxwell_A
from lanczos_tpu.models.maxwell_stacked import StackedMaxwellOperator
from lanczos_tpu.models.rhs import gaussian_matrix_B, gaussian_vector_b


@pytest.fixture(scope="module")
def ops():
    n = 3
    return (
        MaxwellOperator.create(n, n, n, dtype=jnp.float32),
        StackedMaxwellOperator.create(n, n, n, dtype=jnp.float32),
    )


def test_pack_unpack_roundtrip(ops, rng):
    _, pop = ops
    b = rng.standard_normal(pop.n).astype(np.float32)
    u = pop.pack(b)
    assert u.shape == pop.state_shape
    np.testing.assert_array_equal(np.asarray(pop.unpack(u)), b)
    # block-major roundtrip
    B = rng.standard_normal((3, pop.n)).astype(np.float32)
    U = pop.pack(B)
    assert U.shape == (3,) + pop.state_shape
    np.testing.assert_array_equal(np.asarray(pop.unpack(U)), B)


def test_mv_matches_reference(ops, rng):
    ref, pop = ops
    b = rng.standard_normal(pop.n).astype(np.float32)
    want = np.asarray(ref.mv(jnp.asarray(b)))
    got = np.asarray(pop.unpack(pop.mv(pop.pack(b))))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_mv_scipy_oracle(ops, rng):
    _, pop = ops
    a = assemble_maxwell_A(3, 3, 3)
    b = rng.standard_normal(pop.n).astype(np.float32)
    got = np.asarray(pop.unpack(pop.mv(pop.pack(b))))
    np.testing.assert_allclose(got, a @ b, rtol=2e-5, atol=2e-5)


def test_mv_preserves_pad_zeros(ops, rng):
    """The zero-pad invariant must survive an application (chaining)."""
    _, pop = ops
    b = rng.standard_normal(pop.n).astype(np.float32)
    u = pop.mv(pop.mv(pop.pack(b)))
    # zero outside interiors: unpack . pack is identity on interior, so
    # compare the full state against pack(unpack(state))
    np.testing.assert_array_equal(
        np.asarray(u), np.asarray(pop.pack(pop.unpack(u)))
    )


def test_mm_matches_reference(ops, rng):
    ref, pop = ops
    B = rng.standard_normal((4, pop.n)).astype(np.float32)
    want = np.asarray(ref.mm(jnp.asarray(B)))
    got = np.asarray(pop.unpack(pop.mm(pop.pack(B))))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_vector_lanczos_on_stacked_state(ops, rng):
    ref, pop = ops
    b = np.asarray(gaussian_vector_b(3, pop.n), np.float32)
    lc = 20
    r1 = vector_lanczos(ref, jnp.asarray(b), 6, lc)
    r2 = vector_lanczos(
        pop, pop.pack(b), 6, trace_fn=pop.trace_fn(lc)
    )
    np.testing.assert_allclose(
        np.asarray(r2.alphas), np.asarray(r1.alphas), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(r2.betas), np.asarray(r1.betas), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(r2.trace), np.asarray(r1.trace), rtol=2e-4, atol=2e-5
    )


def test_block_lanczos_on_stacked_state(ops, rng):
    ref, pop = ops
    B = np.asarray(gaussian_matrix_B(3, pop.n, 4), np.float32)
    lc = 20
    # fused=False on both: this test compares the two OPERATOR
    # implementations through the same (materialized) recurrence; the
    # fused path's deferred Gram algebra amplifies the operators'
    # eps-level rounding differences beyond the tolerance here (its own
    # equivalence is covered in tests/test_block_dense.py)
    r1 = block_lanczos(
        ref, jnp.asarray(B), 4, lc, eig_backend="lax", fused=False
    )
    r2 = block_lanczos(
        pop, pop.pack(B), 4, eig_backend="lax", trace_fn=pop.trace_fn(lc),
        fused=False,
    )
    np.testing.assert_allclose(
        np.asarray(r2.alphas), np.asarray(r1.alphas), rtol=2e-2, atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(r2.betas), np.asarray(r1.betas), rtol=2e-2, atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(r2.trace), np.asarray(r1.trace), rtol=2e-2, atol=1e-2
    )


def test_bf16_state_mv(rng):
    """bfloat16-state operator: f32 weights/accumulation, bf16 storage;
    matches the f32 operator to input-quantization accuracy (~1e-2)."""
    from lanczos_tpu.models.maxwell_stacked import StackedMaxwellOperator

    ref = MaxwellOperator.create(5, 6, 7, dtype=jnp.float32)
    op = StackedMaxwellOperator.create(5, 6, 7, dtype=jnp.bfloat16)
    assert op.dtype == jnp.bfloat16
    assert op.wz.dtype == jnp.float32

    x = rng.standard_normal(ref.n).astype(np.float32)
    y_ref = np.asarray(ref.mv(jnp.asarray(x)))
    u = op.pack(jnp.asarray(x))
    assert u.dtype == jnp.bfloat16
    y = np.asarray(op.unpack(op.mv(u))).astype(np.float32)
    rel = np.abs(y - y_ref).max() / np.abs(y_ref).max()
    assert rel < 5e-2, rel


def test_mv_non_cubic_scipy(rng):
    """Non-cubic grid (every axis a different extent) vs scipy."""
    op = StackedMaxwellOperator.create(5, 6, 7, dtype=jnp.float64)
    a = assemble_maxwell_A(5, 6, 7)
    b = rng.standard_normal(op.n)
    got = np.asarray(op.unpack(op.mv(op.pack(b))))
    np.testing.assert_allclose(got, a @ b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("p", [1, 3])
def test_fdtd_on_stacked_state(rng, p):
    """Forward-Euler FDTD on the stacked state == on the flat state."""
    from lanczos_tpu.methods.fdtd import fdtd_block, fdtd_vector

    ref = MaxwellOperator.create(4, 5, 3, dtype=jnp.float64)
    op = StackedMaxwellOperator.create(4, 5, 3, dtype=jnp.float64)
    b = rng.standard_normal((p, op.n))
    if p == 1:
        want = fdtd_vector(ref, jnp.asarray(b[0]), 50, 100.0)
        got = op.unpack(fdtd_vector(op, op.pack(b[0]), 50, 100.0))
    else:
        want = fdtd_block(ref, jnp.asarray(b), 50, 100.0)
        got = op.unpack(fdtd_block(op, op.pack(b), 50, 100.0))
    assert float(jnp.abs(want - b).max()) > 1e-3  # the run moved the state
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("p", [1, 3])
def test_fused_on_stacked_state(rng, p):
    """The fused recurrence on the stacked state reproduces the
    materialized one (f64: exact up to algebra reordering)."""
    op = StackedMaxwellOperator.create(4, 4, 5, dtype=jnp.float64)
    b = op.pack(rng.standard_normal((p, op.n)))
    tf = op.trace_fn(11)
    r0 = block_lanczos(op, b, 6, trace_fn=tf, fused=False)
    r1 = block_lanczos(op, b, 6, trace_fn=tf, fused=True)
    for name in ("alphas", "betas", "trace", "beta_final"):
        x = np.asarray(getattr(r0, name))
        np.testing.assert_allclose(np.asarray(getattr(r1, name)), x,
                                   atol=1e-10 * np.abs(x).max(),
                                   err_msg=name)
