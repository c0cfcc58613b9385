"""Assembled matrices through the single-device operators (gathered
`EllMatrix`, `io.auto_operator`'s DIA/ELL choice, `bsr_from_scipy`) vs
scipy: the fixtures of the reference's `ell::SpMV/SpMM` checks
(`spmv_spmm.hpp:106-199`), banded, scattered, rectangular, RCM-permuted,
block-sparse, and block-Lanczos eigsh end to end."""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

import jax
import jax.numpy as jnp

from lanczos_tpu.io import auto_operator
from lanczos_tpu.methods.eigs import block_lanczos_eigsh, ritz_residuals
from lanczos_tpu.models.banded import synth_suitesparse_banded
from lanczos_tpu.models.laplacian import laplacian_2d_scipy
from lanczos_tpu.ops.formats import (
    BsrMatrix,
    DiaMatrix,
    EllMatrix,
    bsr_from_scipy,
    ell_from_scipy,
)

RNG = np.random.default_rng(42)
BUILDERS = {"ell": ell_from_scipy, "auto": auto_operator}


def _check(a, build, p=4, tol=2e-5):
    A = build(a.astype(np.float32))
    X = RNG.standard_normal((p, a.shape[1])).astype(np.float32)
    Y = np.asarray(A.mm(jnp.asarray(X)))
    Yref = (a @ X.T).T
    assert np.abs(Y - Yref).max() / max(np.abs(Yref).max(), 1e-30) < tol
    return A


def _band(n, k=1):
    return sp.diags(
        [np.ones(n - abs(o)) * (2.0 if o == 0 else -1.0)
         for o in range(-k, k + 1)],
        list(range(-k, k + 1)), format="csr",
    ).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(BUILDERS))
@pytest.mark.parametrize("case", ["tridiagonal", "wide_band", "band_noise",
                                  "unstructured", "laplacian"])
def test_mm_matches_scipy(kind, case):
    n = 1200
    a = {
        "tridiagonal": lambda: _band(1000),
        "wide_band": lambda: _band(2000, k=5),
        "band_noise": lambda: (_band(n) + sp.random(
            n, n, density=0.003, random_state=1)).tocsr(),
        "unstructured": lambda: sp.random(500, 500, density=0.02,
                                          random_state=2, format="csr"),
        "laplacian": lambda: laplacian_2d_scipy(30, 30),
    }[case]()
    _check(a, BUILDERS[kind])


def test_auto_operator_choice():
    """DIA for few distinct diagonals, gathered ELL otherwise."""
    assert isinstance(auto_operator(_band(300)), DiaMatrix)
    scat = sp.random(400, 400, density=0.02, random_state=3, format="csr")
    assert isinstance(auto_operator(scat), EllMatrix)


def test_rectangular_and_ragged_rows():
    a = sp.random(300, 900, density=0.01, random_state=3, format="csr")
    _check(a, ell_from_scipy, p=3)
    _check(_band(999)[:997, :999].tocsr(), auto_operator)


def test_rcm_permuted_matches():
    """An RCM-permuted matrix is the same operator up to the permutation:
    P A P^T x = P (A (P^T x))."""
    n2 = 200
    B = sp.diags([np.ones(n2), 0.5 * np.ones(n2 - 1)], [0, 1],
                 shape=(n2, n2))
    a = sp.bmat([[None, B], [B.T, None]]).tocsr().astype(np.float32)
    perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    ap = a[perm][:, perm].tocsr()
    x = RNG.standard_normal(2 * n2).astype(np.float32)
    for build in BUILDERS.values():
        y = np.asarray(build(ap).mv(jnp.asarray(x[perm])))
        np.testing.assert_allclose(y, (a @ x)[perm], rtol=1e-5, atol=1e-5)


def test_mv_matches_mm():
    a = _band(700, k=2)
    A = ell_from_scipy(a)
    x = RNG.standard_normal(700).astype(np.float32)
    np.testing.assert_allclose(np.asarray(A.mv(jnp.asarray(x))), a @ x,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(A.mm(jnp.asarray(x[None])))[0], a @ x,
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_to_dense(kind):
    a = (_band(400) + sp.random(400, 400, density=0.002, random_state=5,
                                format="csr")).tocsr().astype(np.float32)
    np.testing.assert_allclose(np.asarray(BUILDERS[kind](a).to_dense()),
                               a.toarray(), rtol=1e-6, atol=1e-6)


def test_duplicate_entries_sum():
    rows = np.array([0, 0, 5, 5, 5])
    cols = np.array([3, 3, 7, 7, 7])
    vals = np.array([1.0, 2.0, 1.0, 1.0, 1.0], np.float32)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(200, 200))
    x = np.zeros(200, np.float32)
    x[3], x[7] = 1.0, 1.0
    for A in (ell_from_scipy(a), auto_operator(a)):
        y = np.asarray(A.mv(jnp.asarray(x)))
        assert y[0] == pytest.approx(3.0) and y[5] == pytest.approx(3.0)


def test_pytree_jittable():
    a = _band(300)
    A = ell_from_scipy(a)
    x = jnp.asarray(RNG.standard_normal(300).astype(np.float32))
    f = jax.jit(lambda A, x: A.mv(x))
    np.testing.assert_allclose(np.asarray(f(A, x)), a @ np.asarray(x),
                               rtol=1e-5, atol=1e-5)


def _block_tridiagonal(n, bs, rng):
    nbr = n // bs
    tri = sp.diags([np.ones(nbr - 1), np.ones(nbr), np.ones(nbr - 1)],
                   [-1, 0, 1], format="csr")
    dense = rng.standard_normal((tri.nnz, bs, bs)) * 0.1
    return sp.bsr_matrix((dense, tri.indices, tri.indptr),
                         shape=(n, n)).tocsr().astype(np.float32)


def test_bsr_bs8_matches_dense(rng):
    """BASELINE config 3 (bs=8 BSR SpMM): mm and to_dense vs scipy."""
    a = _block_tridiagonal(128, 8, rng)
    op = bsr_from_scipy(a, block_size=8)
    assert isinstance(op, BsrMatrix) and op.block_size == 8
    x = rng.standard_normal((3, 128)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.mm(jnp.asarray(x))),
                               (a @ x.T).T, atol=1e-4)
    np.testing.assert_allclose(np.asarray(op.to_dense()), a.toarray(),
                               atol=1e-6)


def test_bsr_bs8_eigsh_end_to_end(rng):
    """Config-3 end to end: block-Lanczos eigsh on the bs=8 BSR operator
    vs scipy."""
    from scipy.sparse.linalg import eigsh as seig

    a = _block_tridiagonal(256, 8, rng)
    a = (a + a.T).astype(np.float32)
    a = (a + sp.diags(np.asarray(abs(a).sum(axis=1)).ravel())).astype(
        np.float32)
    op = bsr_from_scipy(a, block_size=8)
    b = jnp.asarray(rng.standard_normal((4, 256)), jnp.float32)
    vals, _, _ = block_lanczos_eigsh(op, b, 14, 3, reorth="full")
    ref = seig(a.astype(np.float64), k=3, which="LA",
               return_eigenvectors=False)[::-1]
    np.testing.assert_allclose(np.asarray(vals), ref, rtol=2e-3)


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_lanczos_end_to_end(kind):
    """The banded SuiteSparse-style fixture (`models/banded.py`) through
    block-Lanczos eigsh with periodic reorth: measured residuals and the
    five separated top eigenvalues."""
    n = 20_000
    a = synth_suitesparse_banded(n)
    op = BUILDERS[kind](a)
    b = jnp.asarray(RNG.standard_normal((8, n)).astype(np.float32))
    vals, vecs, _ = block_lanczos_eigsh(op, b, 8, 5, reorth="periodic",
                                        compute_vectors=True)
    assert np.asarray(ritz_residuals(op, vals, vecs)).max() < 1e-3
    from scipy.sparse.linalg import eigsh as seig

    ref = np.sort(seig(a.astype(np.float64), k=5, which="LA",
                       return_eigenvectors=False))[::-1]
    np.testing.assert_allclose(np.asarray(vals), ref, rtol=1e-4)
