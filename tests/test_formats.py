"""Sparse container SpMV/SpMM vs scipy dense oracle (SURVEY.md §4a)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from lanczos_tpu.ops import (
    bsr_from_scipy,
    coo_from_scipy,
    csr_from_scipy,
    dia_from_scipy,
    ell_from_scipy,
)
from lanczos_tpu.models.laplacian import laplacian_2d_scipy
from lanczos_tpu.models.maxwell import assemble_maxwell_A

FROMS = {
    "ell": ell_from_scipy,
    "csr": csr_from_scipy,
    "coo": coo_from_scipy,
    "dia": dia_from_scipy,
    "bsr": lambda a, dtype: bsr_from_scipy(a, block_size=4, dtype=dtype),
}


def _random_sparse(rng, n, m, density=0.05):
    a = sp.random(n, m, density=density, random_state=np.random.RandomState(7))
    return a.tocsr()


@pytest.mark.parametrize("fmt", sorted(FROMS))
@pytest.mark.parametrize("case", ["random", "laplacian", "maxwell"])
def test_spmv_matches_scipy(fmt, case, rng):
    if case == "random":
        a = _random_sparse(rng, 93, 93)
    elif case == "laplacian":
        a = laplacian_2d_scipy(11)
    else:
        a = assemble_maxwell_A(2, 3, 2)
    mat = FROMS[fmt](a, dtype=jnp.float64)
    x = rng.standard_normal(a.shape[1])
    got = np.asarray(mat.mv(jnp.asarray(x)))
    np.testing.assert_allclose(got, a @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fmt", sorted(FROMS))
def test_spmm_matches_scipy(fmt, rng):
    a = laplacian_2d_scipy(9)
    mat = FROMS[fmt](a, dtype=jnp.float64)
    X = rng.standard_normal((6, a.shape[1]))  # block-major (p, n)
    got = np.asarray(mat.mm(jnp.asarray(X))).T
    X = X.T
    np.testing.assert_allclose(got, a @ X, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fmt", sorted(FROMS))
def test_jit_and_scan_compatible(fmt, rng):
    a = laplacian_2d_scipy(6)
    mat = FROMS[fmt](a, dtype=jnp.float64)
    x = jnp.asarray(rng.standard_normal(a.shape[1]))

    @jax.jit
    def three_steps(m, v):
        def body(carry, _):
            return m.mv(carry), None

        out, _ = jax.lax.scan(body, v, None, length=3)
        return out

    got = np.asarray(three_steps(mat, x))
    want = a @ (a @ (a @ x))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_ell_to_dense(rng):
    a = _random_sparse(rng, 40, 40)
    mat = ell_from_scipy(a, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(mat.to_dense()), a.toarray(), atol=1e-14)


def test_ell_row_padding_is_harmless(rng):
    a = laplacian_2d_scipy(5)  # 25 rows -> padded to 32
    mat = ell_from_scipy(a, dtype=jnp.float64, row_pad=32)
    assert mat.padded_rows == 32
    x = rng.standard_normal(25)
    np.testing.assert_allclose(np.asarray(mat.mv(jnp.asarray(x))), a @ x, atol=1e-12)


def test_ell_diagonal_helpers(rng):
    """EllMatrix.mult_diagonal / diagonal / diag_inv / diag_sqrt match the
    scipy dense equivalents (reference `ell_matrix.hpp:302-361`)."""
    import scipy.sparse as sp

    from lanczos_tpu.ops.formats import ell_from_scipy

    n = 37
    a = sp.random(n, n, density=0.15, random_state=7, format="csr")
    a = a + sp.eye(n) * 2.0  # ensure a nonzero diagonal
    ell = ell_from_scipy(a)
    w = rng.random(n).astype(np.float32) + 0.5

    got = np.asarray(ell.mult_diagonal(jnp.asarray(w)).to_dense())
    want = (a @ sp.diags(w)).toarray()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)

    d = a.diagonal()
    np.testing.assert_allclose(np.asarray(ell.diagonal()), d, rtol=2e-6)
    np.testing.assert_allclose(np.asarray(ell.diag_inv()), 1.0 / d, rtol=2e-6)
    np.testing.assert_allclose(
        np.asarray(ell.diag_sqrt()), np.sqrt(d), rtol=2e-6
    )


@pytest.mark.parametrize("maker", ["coo", "csr", "bsr", "dia", "ell"])
def test_to_dense_roundtrip(rng, maker):
    """Every container's to_dense (the reference's print_as_dense debug
    surface, ell_matrix.hpp:473-527) reproduces the source matrix."""
    import scipy.sparse as sp

    from lanczos_tpu.ops.formats import (
        bsr_from_scipy,
        coo_from_scipy,
        csr_from_scipy,
        dia_from_scipy,
        ell_from_scipy,
    )

    n, m = 37, 41
    a = sp.random(n, m, density=0.15, random_state=7, format="csr")
    a.data = np.round(a.data * 8) + 1.0  # exact in f32
    make = {
        "coo": coo_from_scipy,
        "csr": csr_from_scipy,
        "dia": dia_from_scipy,
        "ell": ell_from_scipy,
        "bsr": lambda x: bsr_from_scipy(x, block_size=8),
    }[maker]
    op = make(a)
    dense = np.asarray(op.to_dense())
    ref = a.toarray()
    assert dense.shape == ref.shape
    np.testing.assert_allclose(dense, ref, rtol=0, atol=1e-6)
