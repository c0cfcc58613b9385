"""Distributed stacked Maxwell operator on the 8-device CPU mesh.

Z-slab decomposition + one-plane ppermute halo exchange must reproduce
the scipy-assembled operator and the single-chip Lanczos results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lanczos_tpu.methods.block_lanczos import block_lanczos
from lanczos_tpu.methods.expm_action import lanczos_expm_action
from lanczos_tpu.methods.vector_lanczos import vector_lanczos
from lanczos_tpu.models.maxwell import MaxwellOperator, assemble_maxwell_A
from lanczos_tpu.models.rhs import gaussian_matrix_B, gaussian_vector_b
from lanczos_tpu.parallel import make_mesh
from lanczos_tpu.parallel.dist_stencil import DistributedStackedMaxwell


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8
    return make_mesh(8)


@pytest.fixture(scope="module")
def dist_op(mesh):
    # nz=7 -> z extent 8 -> 1 interior row per shard: maximum halo stress
    return DistributedStackedMaxwell.create(5, 6, 7, mesh, dtype=jnp.float32)


def test_pack_unpack_roundtrip(dist_op, rng):
    b = rng.standard_normal(dist_op.n).astype(np.float32)
    np.testing.assert_array_equal(dist_op.unpack(dist_op.pack(b)), b)


def test_mv_matches_scipy(dist_op, rng):
    a = assemble_maxwell_A(5, 6, 7)
    b = rng.standard_normal(dist_op.n).astype(np.float32)
    got = dist_op.unpack(jax.jit(lambda op, u: op.mv(u))(dist_op, dist_op.pack(b)))
    np.testing.assert_allclose(got, a @ b, rtol=2e-5, atol=2e-5)


def test_mm_matches_scipy(dist_op, rng):
    a = assemble_maxwell_A(5, 6, 7)
    B = rng.standard_normal((3, dist_op.n)).astype(np.float32)
    got = dist_op.unpack(jax.jit(lambda op, u: op.mm(u))(dist_op, dist_op.pack(B)))
    np.testing.assert_allclose(got, (a @ B.T).T, rtol=2e-5, atol=2e-5)


def test_distributed_vector_lanczos_matches_single(mesh, rng):
    n_grid = 4
    ref_op = MaxwellOperator.create(n_grid, n_grid, n_grid, dtype=jnp.float32)
    dop = DistributedStackedMaxwell.create(
        n_grid, n_grid, n_grid, mesh, dtype=jnp.float32
    )
    b = np.asarray(gaussian_vector_b(n_grid, dop.n), np.float32)
    lc = 30
    r1 = vector_lanczos(ref_op, jnp.asarray(b), 6, lc)
    r2 = vector_lanczos(dop, dop.pack(b), 6, trace_fn=dop.trace_fn(lc))
    np.testing.assert_allclose(
        np.asarray(r2.alphas), np.asarray(r1.alphas), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(r2.betas), np.asarray(r1.betas), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(r2.trace), np.asarray(r1.trace), rtol=1e-3, atol=1e-4
    )


def test_distributed_block_lanczos_matches_single(mesh, rng):
    n_grid = 4
    ref_op = MaxwellOperator.create(n_grid, n_grid, n_grid, dtype=jnp.float32)
    dop = DistributedStackedMaxwell.create(
        n_grid, n_grid, n_grid, mesh, dtype=jnp.float32
    )
    B = np.asarray(gaussian_matrix_B(n_grid, dop.n, 3), np.float32)
    r1 = block_lanczos(ref_op, jnp.asarray(B), 4, eig_backend="lax")
    r2 = block_lanczos(dop, dop.pack(B), 4, eig_backend="lax")
    np.testing.assert_allclose(
        np.asarray(r2.alphas), np.asarray(r1.alphas), rtol=2e-2, atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(r2.betas), np.asarray(r1.betas), rtol=2e-2, atol=1e-2
    )
