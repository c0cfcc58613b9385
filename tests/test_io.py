"""Matrix IO: .mtx (native + scipy paths) and .npz loaders, operator
construction (BASELINE configs 4-5 entry point)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.io import mmwrite

from lanczos_tpu.io import load_sparse, operator_from_file
from lanczos_tpu.models.laplacian import laplacian_2d_scipy


def _random_sym(n, rng, density=0.05):
    a = sp.random(n, n, density=density, random_state=42, format="csr")
    return (a + a.T).tocsr()


def test_load_mtx_general(tmp_path, rng):
    a = sp.random(40, 40, density=0.1, random_state=1, format="coo")
    p = str(tmp_path / "g.mtx")
    mmwrite(p, a)
    got = load_sparse(p)
    np.testing.assert_allclose(got.toarray(), a.toarray(), atol=0)


def test_load_mtx_symmetric(tmp_path, rng):
    a = _random_sym(50, rng)
    p = str(tmp_path / "s.mtx")
    mmwrite(p, a, symmetry="symmetric")
    got = load_sparse(p)
    np.testing.assert_allclose(got.toarray(), a.toarray(), atol=0)


def test_load_npz(tmp_path, rng):
    a = _random_sym(30, rng)
    p = str(tmp_path / "m.npz")
    sp.save_npz(p, a.tocsr())
    got = load_sparse(p)
    np.testing.assert_allclose(got.toarray(), a.toarray(), atol=0)


@pytest.mark.parametrize("fmt", ["ell", "csr", "coo", "bsr", "dia"])
def test_operator_from_file(tmp_path, rng, fmt):
    import jax.numpy as jnp

    a = _random_sym(48, rng, density=0.1)
    p = str(tmp_path / "op.mtx")
    mmwrite(p, a)
    op = operator_from_file(p, format=fmt)
    x = rng.standard_normal(48).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(op.mv(jnp.asarray(x))), a @ x, rtol=1e-4, atol=1e-5
    )


def test_operator_from_file_distributed(tmp_path, rng):
    import jax
    import jax.numpy as jnp

    from lanczos_tpu.parallel import make_mesh

    n = 64
    diags = [rng.standard_normal(n) + 4, rng.standard_normal(n - 1),
             rng.standard_normal(n - 1)]
    a = sp.diags([diags[0], diags[1], diags[1]], [0, 1, -1]).tocsr()
    p = str(tmp_path / "band.mtx")
    mmwrite(p, a)
    mesh = make_mesh(jax.device_count())
    op = operator_from_file(p, format="halo", mesh=mesh)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(op.unpad_vector(op.mv(op.pad_vector(x))))
    np.testing.assert_allclose(y, a @ x, rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_auto_operator_selection(rng):
    """format='auto' picks DIA for few-diagonal matrices and gathered
    ELL for everything else."""
    import scipy.sparse as sp

    from lanczos_tpu.io import auto_operator
    from lanczos_tpu.ops.formats import DiaMatrix, EllMatrix

    lap = laplacian_2d_scipy(20, 20)
    assert isinstance(auto_operator(lap), DiaMatrix)

    # banded but many-diagonal: gathered ELL
    n = 2000
    offs = list(range(-20, 21))
    band = sp.diags([rng.standard_normal(n - abs(o)) for o in offs],
                    offs).tocsr()
    op = auto_operator(band)
    assert isinstance(op, EllMatrix)
    x = rng.standard_normal(n).astype(np.float32)
    y = op.mv(jnp.asarray(x, jnp.float32))
    ref = band @ x
    assert np.linalg.norm(np.asarray(y)[:n] - ref) < 1e-4 * np.linalg.norm(ref)

    # scattered random: gathered ELL
    scat = sp.random(1500, 1500, density=0.004, random_state=0,
                     format="csr")
    assert isinstance(auto_operator(scat), EllMatrix)
