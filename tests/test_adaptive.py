"""Adaptive block Lanczos + precision-policy regression tests.

Covers the round-3 robustness work:
  * full-f32 contraction precision (`ops/precision.py`): basis
    orthogonality and TSQR Q-factor quality must sit at f32-eps level,
    not the bf16 floor JAX's default matmul precision would give;
  * post-normalization basis cleanup: on a matrix with a few
    well-separated dominant modes the residual block goes numerically
    rank-deficient within 2-3 steps; without the cleanup the computed T
    drifts off V^T A V and Ritz values carry 1e-3*||A|| errors UNDER
    tiny claimed bounds;
  * replace_dead adaptive restart, newton sqrtm's condition floor, and
    the qr-path beta_final (TSQR R, not a sqrtm of a singular Gram).

Reference counterpart: none — the reference's sqrtm normalization
(`methods/block_lanczos.hpp:28-34`) divides by ~0 and diverges on these
fixtures; this is beyond-reference robustness.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from lanczos_tpu.methods.block_lanczos import block_lanczos
from lanczos_tpu.ops.smalleig import newton_sqrtm_invsqrtm
from lanczos_tpu.ops.tridiag import assemble_block_tridiagonal
from lanczos_tpu.ops.tsqr import tsqr


def spiky_spd(n, seed=0, spikes=(50.0, 45.0, 40.0)):
    """Banded SPD matrix with len(spikes) well-separated dominant modes:
    the block-Lanczos stress case — the residual block goes numerically
    rank-deficient as soon as the spikes converge (2-3 steps)."""
    rng = np.random.default_rng(seed)
    offs = [0, 1, -1, 7, -7]
    diags = [np.zeros(n)] + [
        rng.standard_normal(n - abs(o)) * 0.5 for o in offs[1:]
    ]
    a = sp.diags(diags, offs, format="csr")
    a = 0.5 * (a + a.T)
    rowsum = np.asarray(np.abs(a).sum(axis=1)).ravel()
    sp_diag = np.zeros(n)
    sp_diag[rng.choice(n, size=len(spikes), replace=False)] = spikes
    return (a + sp.diags(rowsum + 1.0 + sp_diag)).tocsr().astype(np.float32)


def test_tsqr_orthonormality_is_f32_not_bf16():
    # guards the precision policy: with default (bf16-rounding) matmul
    # precision the recombine product degrades Q^T Q to ~2e-3
    rng = np.random.default_rng(0)
    a = rng.standard_normal((20096, 8)).astype(np.float32)
    q, r = tsqr(jnp.asarray(a))
    q = np.asarray(q)
    assert np.abs(q.T @ q - np.eye(8)).max() < 2e-5
    assert np.abs(q @ np.asarray(r) - a).max() < 1e-3


@pytest.mark.parametrize("replace_dead", [False, True])
def test_spiky_matrix_ritz_accuracy(replace_dead):
    """qr + full reorth + breakdown_eps on the rank-collapse fixture:
    Ritz values must match the dense oracle and the residual bound must
    be HONEST (no tiny bound on a wrong value)."""
    n, p, m = 4000, 6, 8
    a = spiky_spd(n)
    dense = a.toarray().astype(np.float64)
    true = np.sort(np.linalg.eigvalsh(dense))[::-1][:3]

    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal((p, n)).astype(np.float32))
    from lanczos_tpu.ops.operator import MatrixOperator

    op = MatrixOperator(jnp.asarray(a.toarray().astype(np.float32)))
    res = jax.block_until_ready(
        block_lanczos(
            op, b, m, reorth="full", normalize="qr",
            eig_backend="newton", breakdown_eps=1e-4,
            replace_dead=replace_dead, store_basis=True,
        )
    )
    # basis stays orthonormal at f32 level through the rank collapse
    v = np.asarray(res.basis).reshape(m * p, n)
    live = np.linalg.norm(v, axis=1) > 0.5
    vl = v[live]
    assert np.abs(vl @ vl.T - np.eye(live.sum())).max() < 5e-5
    if replace_dead:
        assert live.all()  # restart keeps the full block width

    t = np.asarray(assemble_block_tridiagonal(res.alphas, res.betas[1:]))
    w, s = np.linalg.eigh(t)
    order = np.argsort(w)[::-1]
    ritz = w[order[:3]]
    np.testing.assert_allclose(ritz, true, rtol=5e-5)

    # honest bound: claimed |beta_final s| must dominate the measured
    # ||A y - theta y|| of the top Ritz pair
    bf = np.asarray(res.beta_final)
    claimed = np.linalg.norm(bf @ s[-p:, order[0]])
    y = vl.T @ s[live][:, order[0]]
    y /= np.linalg.norm(y)
    measured = np.linalg.norm(dense @ y - ritz[0] * y)
    assert measured <= max(claimed, 1e-3) * 1.5 + 1e-3


def test_newton_sqrtm_finite_on_singular():
    # rank-1 PSD Gram (the post-convergence residual Gram): the coupled
    # iteration must stay finite (condition floor), not run to inf/NaN
    v = np.array([[1.0, 2.0, 3.0, 4.0]], np.float32)
    g = jnp.asarray(v.T @ v)
    s, si = newton_sqrtm_invsqrtm(g)
    assert np.isfinite(np.asarray(s)).all()
    assert np.isfinite(np.asarray(si)).all()
    # sqrtm of the regularized matrix still squares back to ~G
    np.testing.assert_allclose(
        np.asarray(s @ s), np.asarray(g), atol=5e-3 * float(jnp.linalg.norm(g))
    )


def test_qr_beta_final_finite_after_convergence():
    """beta_final on a converged run: the qr path takes the TSQR R of the
    residual — it must be finite and ~0, not the NaN a newton sqrtm of
    the singular residual Gram used to produce."""
    n, p, m = 1000, 4, 10
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)).astype(np.float64))
    lam = np.linspace(1.0, 2.0, n)
    lam[:4] = [50.0, 40.0, 30.0, 20.0]
    dense = (q * lam) @ q.T
    from lanczos_tpu.ops.operator import MatrixOperator

    op = MatrixOperator(jnp.asarray(dense.astype(np.float32)))
    b = jnp.asarray(rng.standard_normal((p, n)).astype(np.float32))
    res = jax.block_until_ready(
        block_lanczos(
            op, b, m, reorth="full", normalize="qr",
            eig_backend="newton", breakdown_eps=1e-4,
        )
    )
    bf = np.asarray(res.beta_final)
    assert np.isfinite(bf).all()


def test_adaptive_distributed_matches_local():
    """replace_dead + qr TSQR on an 8-device mesh: the sharded adaptive
    path (shard_map TSQR inside the cleanup) must reproduce the
    single-device Ritz values on the rank-collapse fixture."""
    from lanczos_tpu.methods.eigs import block_lanczos_eigsh
    from lanczos_tpu.ops.operator import MatrixOperator
    from lanczos_tpu.parallel.dist_operator import halo_sharded_ell
    from lanczos_tpu.parallel.mesh import make_mesh

    n, p, m = 1600, 4, 10
    a = spiky_spd(n, spikes=(30.0, 25.0, 20.0))
    rng = np.random.default_rng(5)
    b_np = rng.standard_normal((p, n)).astype(np.float32)

    A = halo_sharded_ell(a, make_mesh(8))
    vals_d, _, _ = block_lanczos_eigsh(
        A, A.pad_vector(b_np), m, 3, reorth="full", normalize="qr",
        breakdown_eps=1e-4, replace_dead=True,
    )

    op = MatrixOperator(jnp.asarray(a.toarray().astype(np.float32)))
    vals_l, _, _ = block_lanczos_eigsh(
        op, jnp.asarray(b_np), m, 3, reorth="full", normalize="qr",
        breakdown_eps=1e-4, replace_dead=True,
    )
    true = np.sort(np.linalg.eigvalsh(a.toarray().astype(np.float64)))[::-1][:3]
    np.testing.assert_allclose(np.asarray(vals_l), true, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(vals_d), true, rtol=1e-4)
