"""Row-sharded halo-exchange ELL (`halo_sharded_ell`) on the 8-device CPU
mesh: against scipy and the single-device operator, the zero-halo padded
state, RCM reordering, and distributed block-Lanczos eigsh with the sqrtm,
shard_map TSQR (`normalize="qr"`) and adaptive-restart (`replace_dead`)
normalizations."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from lanczos_tpu.methods.eigs import block_lanczos_eigsh
from lanczos_tpu.models.laplacian import laplacian_2d_scipy
from lanczos_tpu.ops.formats import ell_from_scipy
from lanczos_tpu.parallel import halo_sharded_ell, make_mesh

RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(8)


def _spiky_laplacian(side=40):
    n = side * side
    spikes = np.zeros(n)
    spikes[:3] = [10.0, 8.0, 6.0]
    return (laplacian_2d_scipy(side, side) + sp.diags(spikes)).tocsr().astype(
        np.float32)


def test_mm_matches_scipy(mesh):
    a = laplacian_2d_scipy(60, 60).astype(np.float32)
    A = halo_sharded_ell(a, mesh)
    X = RNG.standard_normal((4, a.shape[0])).astype(np.float32)
    Y = np.asarray(A.unpad_vector(A.mm(A.pad_vector(X))))
    np.testing.assert_allclose(Y, (a @ X.T).T, rtol=1e-5, atol=1e-5)


def test_chain_preserves_zero_halos(mesh):
    """Padded rows stay zero across chained calls, so global dots never
    count them."""
    a = laplacian_2d_scipy(40, 37).astype(np.float32)  # n not a multiple of 8
    A = halo_sharded_ell(a, mesh)
    X = RNG.standard_normal((2, a.shape[0])).astype(np.float32)
    Y2p = A.mm(A.mm(A.pad_vector(X)))
    ref2 = (a @ (a @ X.T)).T
    np.testing.assert_allclose(np.asarray(A.unpad_vector(Y2p)), ref2,
                               rtol=1e-4, atol=1e-4)
    assert float(jnp.sum(Y2p * Y2p)) == pytest.approx(
        float(np.sum(ref2 * ref2)), rel=1e-4)


def test_matches_single_device_ell(mesh):
    """Multi-hop halo (band ~300 > rows_loc 113) against the single-device
    gathered ELL."""
    n = 900
    d = sp.random(n, n, density=0.002, random_state=3, format="coo")
    keep = np.abs(d.row - d.col) <= 300
    d = sp.coo_matrix((d.data[keep], (d.row[keep], d.col[keep])),
                      shape=(n, n))
    a = (laplacian_2d_scipy(30, 30) + d + d.T).tocsr().astype(np.float32)
    Ad = halo_sharded_ell(a, mesh, reorder="none")
    assert Ad.halo > Ad.n_padded // 8
    x = RNG.standard_normal(n).astype(np.float32)
    yd = np.asarray(Ad.unpad_vector(Ad.mv(Ad.pad_vector(x))))
    ys = np.asarray(ell_from_scipy(a).mv(jnp.asarray(x)))
    np.testing.assert_allclose(yd, ys, rtol=1e-5, atol=1e-5)


def test_rcm_reorder_roundtrip(mesh):
    n2 = 200
    B = sp.diags([np.ones(n2), 0.5 * np.ones(n2 - 1)], [0, 1],
                 shape=(n2, n2))
    a = sp.bmat([[None, B], [B.T, None]]).tocsr().astype(np.float32)
    A = halo_sharded_ell(a, mesh, reorder="rcm")
    assert A.perm is not None
    x = RNG.standard_normal(2 * n2).astype(np.float32)
    y = np.asarray(A.unpad_vector(A.mv(A.pad_vector(x))))
    np.testing.assert_allclose(y, a @ x, rtol=1e-5, atol=1e-5)


def test_local_index_receiver(mesh):
    a = laplacian_2d_scipy(40, 40).astype(np.float32)
    A = halo_sharded_ell(a, mesh, reorder="rcm")
    x = RNG.standard_normal(1600).astype(np.float32)
    xp = np.asarray(A.pad_vector(x))
    for i in (0, 511, 512, 1599):
        assert xp[A.local_index(i)] == pytest.approx(x[i])


@pytest.mark.parametrize("kw", [
    {},
    {"normalize": "qr"},
    {"normalize": "qr", "breakdown_eps": 1e-4, "replace_dead": True},
], ids=["sqrtm", "qr_tsqr", "replace_dead"])
def test_block_lanczos_eigsh_distributed(mesh, kw):
    """BASELINE config 4/5 shape: the sharded operator through the
    unchanged block-Lanczos eigsh — Ritz values match the dense spectrum
    and the single-device run."""
    a = _spiky_laplacian()
    A = halo_sharded_ell(a, mesh)
    b_np = RNG.standard_normal((4, a.shape[0])).astype(np.float32)
    vals, _, _ = block_lanczos_eigsh(A, A.pad_vector(b_np), 12, 3,
                                     reorth="full", **kw)
    vals_1, _, _ = block_lanczos_eigsh(ell_from_scipy(a), jnp.asarray(b_np),
                                       12, 3, reorth="full", **kw)
    ref = np.sort(np.linalg.eigvalsh(a.toarray()))[::-1][:3]
    np.testing.assert_allclose(np.asarray(vals), ref, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(vals_1),
                               rtol=1e-4)
