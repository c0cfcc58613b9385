"""Jacobi eigensolver / sqrtm / expm vs numpy oracles (SURVEY.md §4a)."""

import jax.numpy as jnp
import numpy as np
import pytest

from lanczos_tpu.ops.smalleig import expm_sym, jacobi_eigh, sqrtm_invsqrtm
from lanczos_tpu.ops.tridiag import assemble_block_tridiagonal, assemble_tridiagonal


def _rand_sym(rng, p):
    a = rng.standard_normal((p, p))
    return (a + a.T) / 2


def _rand_spd(rng, p, cond=None):
    a = rng.standard_normal((p, max(p, 2 * p)))
    s = a @ a.T / p
    if cond is not None:
        w, v = np.linalg.eigh(s)
        w = np.geomspace(1.0 / cond, 1.0, p)
        s = (v * w) @ v.T
    return s


# N_COL sweep matching the reference benchmarks (lanczos_plots.m): 2..18
@pytest.mark.parametrize("p", [2, 3, 4, 8, 13, 18])
def test_jacobi_eigh_matches_numpy(p, rng):
    a = _rand_sym(rng, p)
    w, v = jacobi_eigh(jnp.asarray(a), sweeps=12)
    w = np.asarray(w)
    v = np.asarray(v)
    # reconstruction
    np.testing.assert_allclose(v @ np.diag(w) @ v.T, a, atol=1e-10)
    # orthogonality
    np.testing.assert_allclose(v.T @ v, np.eye(p), atol=1e-10)
    # eigenvalues match (sorted)
    np.testing.assert_allclose(np.sort(w), np.linalg.eigvalsh(a), atol=1e-10)


def test_jacobi_eigh_batched(rng):
    a = np.stack([_rand_sym(rng, 6) for _ in range(5)])
    w, v = jacobi_eigh(jnp.asarray(a), sweeps=12)
    for i in range(5):
        np.testing.assert_allclose(
            np.sort(np.asarray(w[i])), np.linalg.eigvalsh(a[i]), atol=1e-10
        )


@pytest.mark.parametrize("p", [2, 4, 8, 18])
@pytest.mark.parametrize("backend", ["jacobi", "lax", "newton"])
def test_sqrtm_invsqrtm(p, backend, rng):
    a = _rand_spd(rng, p)
    s, s_inv = sqrtm_invsqrtm(jnp.asarray(a), backend=backend, sweeps=14)
    s = np.asarray(s)
    s_inv = np.asarray(s_inv)
    np.testing.assert_allclose(s @ s, a, atol=1e-9)
    np.testing.assert_allclose(s @ s_inv, np.eye(p), atol=1e-8)


def test_sqrtm_breakdown_pseudoinverse(rng):
    # rank-deficient Gram matrix: pinv path must not blow up
    b = rng.standard_normal((10, 2))
    g = np.zeros((4, 4))
    g[:2, :2] = b.T @ b / 10
    s, s_inv = sqrtm_invsqrtm(
        jnp.asarray(g), backend="lax", breakdown_eps=1e-10
    )
    assert np.all(np.isfinite(np.asarray(s_inv)))
    # s_inv acts as pseudo-inverse of s on the range
    ssi = np.asarray(s) @ np.asarray(s_inv)
    np.testing.assert_allclose(ssi @ np.asarray(s), np.asarray(s), atol=1e-8)


@pytest.mark.parametrize("backend", ["jacobi", "lax"])
def test_expm_sym(backend, rng):
    from scipy.linalg import expm as scipy_expm

    t = _rand_sym(rng, 9)
    got = np.asarray(expm_sym(jnp.asarray(t), backend=backend, sweeps=16))
    np.testing.assert_allclose(got, scipy_expm(t), rtol=1e-9, atol=1e-9)


def test_assemble_tridiagonal():
    alphas = jnp.asarray([1.0, 2.0, 3.0])
    betas = jnp.asarray([4.0, 5.0])
    t = np.asarray(assemble_tridiagonal(alphas, betas))
    want = np.array([[1, 4, 0], [4, 2, 5], [0, 5, 3]], dtype=float)
    np.testing.assert_array_equal(t, want)


def test_assemble_block_tridiagonal(rng):
    m, p = 3, 2
    alphas = rng.standard_normal((m, p, p))
    alphas = (alphas + alphas.transpose(0, 2, 1)) / 2
    betas = rng.standard_normal((m - 1, p, p))
    t = np.asarray(
        assemble_block_tridiagonal(jnp.asarray(alphas), jnp.asarray(betas))
    )
    assert t.shape == (6, 6)
    np.testing.assert_array_equal(t[:2, :2], alphas[0])
    np.testing.assert_array_equal(t[2:4, :2], betas[0])
    np.testing.assert_array_equal(t[:2, 2:4], betas[0].T)
    np.testing.assert_array_equal(t[4:6, 2:4], betas[1])


def test_newton_sqrtm_rejects_breakdown_eps(rng):
    a = _rand_spd(rng, 4)
    with pytest.raises(ValueError, match="rank-revealing"):
        sqrtm_invsqrtm(jnp.asarray(a), backend="newton", breakdown_eps=1e-8)


def test_newton_sqrtm_batched_and_conditioned(rng):
    # moderately ill-conditioned spectrum (the realistic block-Gram range)
    p = 8
    q, _ = np.linalg.qr(rng.standard_normal((p, p)))
    lam = np.logspace(0, -4, p)
    a = (q * lam) @ q.T
    batch = np.stack([a, np.eye(p), 2.0 * a])
    s, s_inv = sqrtm_invsqrtm(jnp.asarray(batch), backend="newton")
    for i in range(3):
        si = np.asarray(s[i])
        np.testing.assert_allclose(si @ si, batch[i], atol=1e-7)
        np.testing.assert_allclose(
            si @ np.asarray(s_inv[i]), np.eye(p), atol=1e-5
        )


def test_jacobi_near_converged_tau_overflow():
    """Near-converged pairs give |tau| ~ 1/apq beyond even f64 range;
    the overflowing tau*tau must leave the rotation at the identity
    (t -> 0), never NaN-poison the sweep."""
    from lanczos_tpu.ops.smalleig import jacobi_eigh

    a = jnp.asarray(
        [[2.0, 1e-300, 0.0], [1e-300, 1.0, 1e-290], [0.0, 1e-290, 0.5]],
        jnp.float64,
    )
    w, v = jacobi_eigh(a, sweeps=10)
    assert bool(jnp.isfinite(w).all() & jnp.isfinite(v).all())
    np.testing.assert_allclose(np.sort(np.asarray(w)), [0.5, 1.0, 2.0],
                               rtol=1e-12)
