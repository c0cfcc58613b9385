"""SpMM + eigsh on a GENERAL assembled sparse matrix.

Matrices that arrive assembled (CSR / .mtx / SuiteSparse downloads) rather
than as a separable stencil go through `io.auto_operator`: DIA (shifted
slices, no gathers) when the nonzeros lie on few diagonals, else the
gathered ELL container — the reference's `ell::SpMM` shape
(`source/kernels/spmv_spmm.hpp:106-199`), whose gathers XLA runs natively.

    python examples/assembled_matrix.py [matrix.mtx]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

import lanczos_tpu as lt
from lanczos_tpu.io import auto_operator
from lanczos_tpu.methods.eigs import ritz_residuals
from lanczos_tpu.models.banded import synth_suitesparse_banded


def main():
    if len(sys.argv) > 1:
        a_sp = lt.load_sparse(sys.argv[1]).tocsr()  # any .mtx / .npz
    else:  # the seeded banded SPD fixture of BASELINE configs 3-5
        a_sp = synth_suitesparse_banded(200_000)

    op = auto_operator(a_sp.astype(np.float32))
    print(f"{a_sp.shape[0]} rows, {a_sp.nnz} nnz -> {type(op).__name__}")

    x = np.random.default_rng(1).standard_normal(a_sp.shape[0])
    y = op.mv(jnp.asarray(x, jnp.float32))
    err = np.linalg.norm(np.asarray(y) - a_sp @ x) / np.linalg.norm(a_sp @ x)
    print(f"SpMV vs scipy rel err: {err:.2e}")

    b = jnp.asarray(
        np.random.default_rng(2).standard_normal((8, a_sp.shape[0])),
        jnp.float32,
    )
    vals, vecs, bound = lt.block_lanczos_eigsh(
        op, b, m=8, k=5, which="LA", reorth="periodic", compute_vectors=True,
    )
    print("top-5 Ritz values :", np.asarray(vals))
    print("residual bounds   :", np.asarray(bound))
    print("measured residuals:", np.asarray(ritz_residuals(op, vals, vecs)))


if __name__ == "__main__":
    main()
