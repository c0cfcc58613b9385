"""Top-k eigenvalues of a 2-D Laplacian (BASELINE.json config 1).

Single-vector Lanczos with full re-orthogonalization on a 10k x 10k
(100x100 grid) 2-D Laplacian in fp64, validated against scipy.

    python examples/eigsh_laplacian.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import lanczos_tpu as lt
from lanczos_tpu.models.laplacian import laplacian_2d_scipy


def main():
    a_sp = laplacian_2d_scipy(100, 100)  # 10,000 x 10,000 CSR
    a = lt.ell_from_scipy(a_sp, dtype=jnp.float64)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(a_sp.shape[0]))

    # The Laplacian's top spectrum is tightly clustered (spacing ~1e-3)
    # with a degenerate pair — exactly the case block Lanczos handles:
    # a width-4 block resolves multiplicity the single vector cannot.
    B = jnp.asarray(np.random.default_rng(0).standard_normal(
        (4, a_sp.shape[0])))
    vals, vecs, resid = lt.block_lanczos_eigsh(
        a, B, m=150, k=5, which="LA", reorth="full", normalize="qr",
        compute_vectors=True,
    )
    print("top-5 Ritz values:", np.asarray(vals))
    print("residual bounds  :", np.asarray(resid))

    from scipy.sparse.linalg import eigsh

    ref = np.sort(eigsh(a_sp, k=5, which="LA")[0])[::-1]
    print("scipy eigsh      :", ref)
    print("max rel err      :", float(np.max(np.abs(vals - ref) / ref)))


if __name__ == "__main__":
    main()
