"""Seeded SuiteSparse-scale banded SPD matrix: the assembled-matrix fixture.

Stands in for the 10M+-row, 100M+-nnz SuiteSparse matrices of BASELINE.json
configs 3-5 (nothing is downloaded): 11 scattered diagonals like a
high-order FD/FE discretization, random entries, diagonally dominant, with
five separated top eigenvalues so top-k convergence is finite.
"""

from __future__ import annotations

import numpy as np

OFFSETS = (0, 1, -1, 7, -7, 64, -64, 513, -513, 4999, -4999)
SPIKES = (500.0, 450.0, 400.0, 350.0, 300.0)


def synth_suitesparse_banded(n: int, seed: int = 0):
    """scipy CSR float32 (n, n), nnz ~ 11n.  Symmetric part of a random
    band plus a dominant diagonal: each row's absolute sum + 1, plus the
    SPIKES at five random rows.  The spikes clear the band continuum's
    edge (~2x the max row sum) by a real gap, so the no-reorth and
    periodic recurrences resolve them before stalling."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    offsets = [o for o in OFFSETS if abs(o) < n]
    diags = [
        np.zeros(n) if o == 0 else rng.standard_normal(n - abs(o)) * 0.5
        for o in offsets
    ]
    a = sp.diags(diags, offsets, format="csr")
    a = 0.5 * (a + a.T)
    rowsum = np.asarray(abs(a).sum(axis=1)).ravel()
    spikes = np.zeros(n)
    spikes[rng.choice(n, size=len(SPIKES), replace=False)] = SPIKES
    a = a + sp.diags(rowsum + 1.0 + spikes)
    return a.tocsr().astype(np.float32)
