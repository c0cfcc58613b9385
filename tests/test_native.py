"""Native (C++) assembly engine vs the pure-Python/scipy paths."""

import jax.numpy as jnp
import numpy as np
import pytest

from lanczos_tpu import native
from lanczos_tpu.models.laplacian import laplacian_2d_scipy
from lanczos_tpu.models.maxwell import (
    assemble_maxwell_A,
    maxwell_ell_operator,
)
from lanczos_tpu.ops.formats import ell_from_scipy

needs_native = pytest.mark.skipif(
    native.load() is None, reason="native toolchain unavailable"
)


@needs_native
def test_native_ell_from_csr_matches_python(rng, monkeypatch):
    a = laplacian_2d_scipy(9, 7).tocsr()
    ours = ell_from_scipy(a, dtype=jnp.float32)
    # force the Python fallback for comparison
    monkeypatch.setattr(native, "ell_from_csr", lambda *a_, **k: None)
    ref = ell_from_scipy(a, dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(ours.data), np.asarray(ref.data))
    np.testing.assert_array_equal(
        np.asarray(ours.indices), np.asarray(ref.indices)
    )


@needs_native
def test_native_ell_f64(rng):
    a = laplacian_2d_scipy(6).tocsr()
    mat = ell_from_scipy(a, dtype=jnp.float64)
    x = rng.standard_normal(a.shape[0])
    np.testing.assert_allclose(
        np.asarray(mat.mv(jnp.asarray(x))), a @ x, rtol=1e-13
    )


@needs_native
def test_native_maxwell_ell_matches_scipy(rng):
    a_ref = assemble_maxwell_A(4, 3, 5)
    mat = maxwell_ell_operator(4, 3, 5)
    assert mat.width == 4
    dense_native = np.zeros(a_ref.shape, np.float64)
    data = np.asarray(mat.data)
    idx = np.asarray(mat.indices)
    for i in range(a_ref.shape[0]):
        for k in range(4):
            dense_native[i, idx[i, k]] += data[i, k]
    np.testing.assert_allclose(dense_native, a_ref.toarray(), rtol=2e-6,
                               atol=1e-9)


@needs_native
def test_native_maxwell_spmv(rng):
    a_ref = assemble_maxwell_A(3, 3, 3)
    mat = maxwell_ell_operator(3, 3, 3)
    x = rng.standard_normal(mat.shape[0]).astype(np.float32)
    got = np.asarray(mat.mv(jnp.asarray(x)))
    np.testing.assert_allclose(got, a_ref @ x, rtol=2e-5, atol=2e-5)
