"""Matrix IO: load external sparse matrices into the framework.

The north-star configs (BASELINE.json 4-5) run block Lanczos on
SuiteSparse matrices; this module loads Matrix Market (`.mtx`, the
SuiteSparse interchange format) and scipy `.npz` files and builds any of
the containers or row-sharded distributed operators from them.

`scipy.io.mmread` in this environment is backed by the native
fast_matrix_market C++ parallel parser (measured ~0.8 s for a 10M-entry
file), so no custom loader is needed; a hand-rolled chunk-parallel C++
parser was benchmarked at 7x SLOWER and removed.
"""

from __future__ import annotations

import os

import numpy as np


def load_sparse(path: str):
    """Load a sparse matrix from .mtx/.mtx.gz (Matrix Market) or .npz
    (scipy.sparse.save_npz).  Returns scipy CSR."""
    import scipy.sparse as sp

    low = path.lower()
    if low.endswith(".npz"):
        return sp.load_npz(path).tocsr()
    if low.endswith((".mtx", ".mtx.gz")):
        from scipy.io import mmread

        a = mmread(path)
        # 'array'-format files come back as a dense ndarray (no .tocsr)
        return sp.csr_matrix(a) if not sp.issparse(a) else a.tocsr()
    raise ValueError(f"unknown sparse matrix format: {path}")


def operator_from_file(
    path: str,
    *,
    format: str = "ell",
    dtype=None,
    mesh=None,
    reorder: str = "auto",
):
    """Build a ready-to-use operator from a matrix file.

    format: "ell" | "csr" | "coo" | "bsr" | "dia" (single-device XLA
    containers) | "auto" (see `auto_operator`), or with `mesh` given:
    "halo" / "ell" (banded row-sharded ELL, ppermute halo exchange, RCM
    per `reorder`) | "gather" (arbitrary sparsity, all-gather) | "auto".
    """
    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.float32
    a = load_sparse(path)

    if format == "auto":
        return auto_operator(a, dtype=dtype, mesh=mesh, reorder=reorder)

    if mesh is not None:
        from lanczos_tpu.parallel import gather_sharded_ell, halo_sharded_ell

        if format in ("halo", "ell"):
            return halo_sharded_ell(a, mesh, dtype=dtype, reorder=reorder)
        if format == "gather":
            return gather_sharded_ell(a, mesh, dtype=dtype)
        raise ValueError(f"unknown distributed format {format!r}")

    from lanczos_tpu.ops import formats as F

    builders = {
        "ell": F.ell_from_scipy,
        "csr": F.csr_from_scipy,
        "coo": F.coo_from_scipy,
        "bsr": F.bsr_from_scipy,
        "dia": F.dia_from_scipy,
    }
    if format not in builders:
        raise ValueError(f"unknown format {format!r}")
    return builders[format](a, dtype=dtype)


def auto_operator(a, *, dtype=None, mesh=None, reorder: str = "auto",
                  max_diags: int = 32):
    """Operator selection for an assembled scipy matrix: on one device, DIA
    (gather-free shifted slices) when the nonzeros lie on <= max_diags
    distinct diagonals, else gathered ELL (the reference's `ell::SpMM`
    shape).  With a mesh: the halo-exchange row-sharded ELL (RCM-reordered
    per `reorder` when that shortens the halo), else the all-gather
    operator for sparsity no reordering makes banded."""
    import jax.numpy as jnp

    import scipy.sparse as sp

    if dtype is None:
        dtype = jnp.float32
    a = a.tocsr() if sp.issparse(a) else sp.csr_matrix(np.asarray(a))

    if mesh is None:
        from lanczos_tpu.ops import formats as F

        coo = a.tocoo()
        ndiag = (
            len(np.unique(coo.col.astype(np.int64) - coo.row)) if coo.nnz else 1
        )
        if a.shape[0] == a.shape[1] and ndiag <= max_diags:
            return F.dia_from_scipy(a, dtype=dtype)
        return F.ell_from_scipy(a, dtype=dtype)

    from lanczos_tpu.parallel import gather_sharded_ell, halo_sharded_ell

    try:
        return halo_sharded_ell(a, mesh, dtype=dtype, reorder=reorder)
    except ValueError:
        return gather_sharded_ell(a, mesh, dtype=dtype)
