"""Sparse matrix containers as JAX pytrees.

Re-design of the reference's single container
(`source/objects/ell_matrix.hpp`): instead of one CUDA ELL class with a
`change_order(4)` float4 re-tiling trick (`ell_matrix.hpp:362`), we provide
ELL / CSR / COO / BSR / DIA pytrees whose SpMV/SpMM run as XLA ops
(gathers + segment sums; BSR block products as one batched einsum).  Rows
are padded to a multiple of ROW_TILE so every kernel sees static shapes.

The padding convention is: padded rows have `data == 0` and column index 0,
so gathered products contribute exactly zero — the analogue of the
reference's `Ell_matrix::padding` (`ell_matrix.hpp:404`) without the
stride-4 layout games.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from lanczos_tpu.ops.precision import HIGHEST
import numpy as np

from lanczos_tpu.ops.operator import LinearOperator

ROW_TILE = 8  # row padding granule; callers may pad more aggressively.


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _as_2d_scipy(a):
    import scipy.sparse as sp

    if not sp.issparse(a):
        a = sp.csr_matrix(np.asarray(a))
    return a


# ---------------------------------------------------------------------------
# ELL
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class EllMatrix(LinearOperator):
    """ELLPACK: row-major (n_rows_pad, width) value/index planes.

    Equivalent capability to reference `Ell_matrix` (`ell_matrix.hpp:11`)
    with arbitrary width (the reference's fast path silently assumes
    width == 4, `spmv_spmm.hpp:116-119`).
    """

    data: jax.Array  # (n_rows_pad, width)
    indices: jax.Array  # (n_rows_pad, width) int32
    n_rows_true: int
    n_cols_true: int

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def padded_rows(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    def mv(self, x: jax.Array) -> jax.Array:
        """y[i] = sum_k data[i,k] * x[idx[i,k]] (reference `ell::SpMV`,
        `spmv_spmm.hpp:106`), as an XLA gather + lane reduction."""
        gathered = jnp.take(x, self.indices, axis=0)  # (rows_pad, width)
        y = jnp.sum(self.data * gathered, axis=1)
        return y[: self.n_rows_true]

    def mm(self, X: jax.Array) -> jax.Array:
        """Fused SpMM, block-major X (p, n) (reference `ell::SpMM`,
        `spmv_spmm.hpp:138`)."""
        gathered = jnp.take(X, self.indices, axis=1)  # (p, rows_pad, width)
        y = jnp.einsum(
            "rw,prw->pr", self.data, gathered,
            preferred_element_type=self.data.dtype, precision=HIGHEST,
        )
        return y[:, : self.n_rows_true]

    def to_dense(self) -> jax.Array:
        n, m = self.shape
        dense = jnp.zeros((self.padded_rows, m), self.dtype)
        rows = jnp.arange(self.padded_rows)[:, None]
        dense = dense.at[rows, self.indices].add(self.data)
        return dense[:n]

    # -- diagonal helpers (reference `Ell_matrix::diag_inv/diag_sqrt/
    # mult_diagonal`, `ell_matrix.hpp:302-361` / kernels `lm`) ------------

    def mult_diagonal(self, w: jax.Array) -> "EllMatrix":
        """A @ diag(w): scale column j by w[j] — the reference's
        symmetrization step A = D * W (`test_lanczos.cu:191`).  One
        gather + multiply on the data plane; indices unchanged."""
        return EllMatrix(
            self.data * jnp.take(w, self.indices, axis=0),
            self.indices, self.n_rows_true, self.n_cols_true,
        )

    def diagonal(self) -> jax.Array:
        """Main-diagonal entries (summing duplicates on the diagonal)."""
        rows = jnp.arange(self.padded_rows)[:, None]
        on_diag = (self.indices == rows) & (rows < self.n_rows_true)
        return jnp.sum(jnp.where(on_diag, self.data, 0), axis=1)[
            : self.n_rows_true
        ]

    def diag_inv(self) -> jax.Array:
        """1/diag (reference `lm::diag_inv`, zeros stay zero)."""
        d = self.diagonal()
        return jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1.0), 0.0)

    def diag_sqrt(self) -> jax.Array:
        """sqrt(diag) (reference `lm::diag_sqrt`)."""
        return jnp.sqrt(self.diagonal())

    def tree_flatten(self):
        return (self.data, self.indices), (self.n_rows_true, self.n_cols_true)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)


def _ell_planes(a, rows_pad: int, width: int, dtype, col_shift=None):
    """Padded (rows_pad, width) ELL value/index planes of a CSR matrix
    (rows longer than width are truncated; pad slots hold data 0, index
    0).  col_shift: optional per-row offset subtracted from the column
    indices (row-local windows of the sharded operators)."""
    n = a.shape[0]
    per_row = np.diff(a.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    slot = np.arange(a.nnz, dtype=np.int64) - np.repeat(
        a.indptr[:-1].astype(np.int64), per_row
    )
    keep = slot < width
    rows, slot = rows[keep], slot[keep]
    cols = a.indices[keep].astype(np.int64)
    if col_shift is not None:
        cols = cols - col_shift[rows]
    data = np.zeros((rows_pad, width), np.dtype(dtype))
    idx = np.zeros((rows_pad, width), np.int32)
    data[rows, slot] = a.data[keep]
    idx[rows, slot] = cols
    return data, idx


def ell_from_scipy(a, dtype=jnp.float32, row_pad: int = ROW_TILE, width: int | None = None) -> EllMatrix:
    a = _as_2d_scipy(a).tocsr()
    a.sum_duplicates()
    n, m = a.shape
    per_row = np.diff(a.indptr)
    w = int(per_row.max()) if width is None else width
    w = max(w, 1)
    rows_pad = _round_up(n, row_pad)

    from lanczos_tpu import native

    packed = native.ell_from_csr(
        a.indptr, a.indices, a.data, n, rows_pad, w, np.dtype(dtype)
    )
    if packed is not None:
        data, idx = packed
    else:  # pure-NumPy fallback (native toolchain unavailable)
        data, idx = _ell_planes(a, rows_pad, w, dtype)
    return EllMatrix(jnp.asarray(data), jnp.asarray(idx), n, m)


# ---------------------------------------------------------------------------
# COO
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CooMatrix(LinearOperator):
    """COO triplets, padded with (row=n_rows_true pad slot trick: padding
    entries carry data == 0 and row/col == 0, contributing nothing)."""

    rows: jax.Array  # (nnz_pad,) int32
    cols: jax.Array  # (nnz_pad,) int32
    data: jax.Array  # (nnz_pad,)
    n_rows_true: int
    n_cols_true: int

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def mv(self, x: jax.Array) -> jax.Array:
        prod = self.data * jnp.take(x, self.cols, axis=0)
        return jax.ops.segment_sum(prod, self.rows, num_segments=self.n_rows_true)

    def mm(self, X: jax.Array) -> jax.Array:
        # X block-major (p, n)
        prod = self.data[None, :] * jnp.take(X, self.cols, axis=1)  # (p, nnz)
        y = jax.ops.segment_sum(
            prod.T, self.rows, num_segments=self.n_rows_true
        )  # (n, p)
        return y.T

    def to_dense(self) -> jax.Array:
        """Debug/introspection dense rebuild (reference
        `Ell_matrix::print_as_dense`, `ell_matrix.hpp:473-527`)."""
        dense = jnp.zeros(self.shape, self.dtype)
        return dense.at[self.rows, self.cols].add(self.data)

    def tree_flatten(self):
        return (self.rows, self.cols, self.data), (self.n_rows_true, self.n_cols_true)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def coo_from_scipy(a, dtype=jnp.float32, nnz_pad: int = 128) -> CooMatrix:
    a = _as_2d_scipy(a).tocoo()
    a.sum_duplicates()
    n, m = a.shape
    nnz = a.nnz
    nnzp = _round_up(max(nnz, 1), nnz_pad)
    rows = np.zeros(nnzp, np.int32)
    cols = np.zeros(nnzp, np.int32)
    data = np.zeros(nnzp, np.dtype(dtype))
    rows[:nnz] = a.row
    cols[:nnz] = a.col
    data[:nnz] = a.data
    return CooMatrix(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(data), n, m)


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CsrMatrix(LinearOperator):
    """CSR with an explicit row-id plane for segment reductions.

    XLA has no native sparse row-pointer kernel; the execution is gather +
    `segment_sum`, so we carry both `indptr` (interop) and the expanded
    `row_ids` (compute path).
    """

    indptr: jax.Array  # (n_rows_true + 1,) int32
    indices: jax.Array  # (nnz_pad,) int32
    data: jax.Array  # (nnz_pad,)
    row_ids: jax.Array  # (nnz_pad,) int32
    n_rows_true: int
    n_cols_true: int

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def mv(self, x: jax.Array) -> jax.Array:
        prod = self.data * jnp.take(x, self.indices, axis=0)
        return jax.ops.segment_sum(prod, self.row_ids, num_segments=self.n_rows_true)

    def mm(self, X: jax.Array) -> jax.Array:
        # X block-major (p, n)
        prod = self.data[None, :] * jnp.take(X, self.indices, axis=1)
        y = jax.ops.segment_sum(
            prod.T, self.row_ids, num_segments=self.n_rows_true
        )
        return y.T

    def to_dense(self) -> jax.Array:
        """Debug/introspection dense rebuild (reference
        `print_as_dense`); padding entries (data 0 at slot (0,0)) vanish."""
        dense = jnp.zeros(self.shape, self.dtype)
        return dense.at[self.row_ids, self.indices].add(self.data)

    def tree_flatten(self):
        return (
            (self.indptr, self.indices, self.data, self.row_ids),
            (self.n_rows_true, self.n_cols_true),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def csr_from_scipy(a, dtype=jnp.float32, nnz_pad: int = 128) -> CsrMatrix:
    a = _as_2d_scipy(a).tocsr()
    a.sum_duplicates()
    n, m = a.shape
    nnz = a.nnz
    nnzp = _round_up(max(nnz, 1), nnz_pad)
    indices = np.zeros(nnzp, np.int32)
    data = np.zeros(nnzp, np.dtype(dtype))
    row_ids = np.full(nnzp, 0, np.int32)
    indices[:nnz] = a.indices
    data[:nnz] = a.data
    row_ids[:nnz] = np.repeat(np.arange(n, dtype=np.int32), np.diff(a.indptr))
    return CsrMatrix(
        jnp.asarray(a.indptr.astype(np.int32)),
        jnp.asarray(indices),
        jnp.asarray(data),
        jnp.asarray(row_ids),
        n,
        m,
    )


# ---------------------------------------------------------------------------
# BSR
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BsrMatrix(LinearOperator):
    """Block-sparse rows in BLOCK-ELL layout: every block-row is padded to
    the same number of blocks `w`, so y is a fixed-width SUM over block
    slots — no `segment_sum` scatter.  Block products are one batched
    einsum, replacing the reference's scalar row loops."""

    data: jax.Array  # (nbr, w, bs, bs)
    block_cols: jax.Array  # (nbr, w) int32 — block-column index (0 padded)
    n_rows_true: int
    n_cols_true: int

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def block_size(self) -> int:
        return self.data.shape[2]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(np.prod(self.data.shape))

    def mv(self, x: jax.Array) -> jax.Array:
        return self.mm(x[None, :])[0]

    def mm(self, X: jax.Array) -> jax.Array:
        # X block-major (p, n)
        bs = self.block_size
        squeeze = X.ndim == 1
        if squeeze:
            X = X[None, :]
        p = X.shape[0]
        Xb = jnp.reshape(
            jnp.pad(X, ((0, 0), (0, (-X.shape[1]) % bs))), (p, -1, bs)
        )
        gathered = jnp.take(Xb, self.block_cols, axis=1)  # (p, nbr, w, bs)
        # contract block and width axes in one einsum; the width sum
        # replaces the scatter
        Yb = jnp.einsum(
            "rwij,prwj->pri", self.data, gathered,
            preferred_element_type=self.dtype, precision=HIGHEST,
        )  # (p, nbr, bs)
        out = jnp.reshape(Yb, (p, -1))[:, : self.n_rows_true]
        return out[0] if squeeze else out

    def to_dense(self) -> jax.Array:
        """Debug/introspection dense rebuild; duplicate padding blocks at
        block-column 0 carry zero data, so `.add` keeps them inert."""
        bs = self.block_size
        nbr, w = self.block_cols.shape
        mpad = ((self.n_cols_true + bs - 1) // bs) * bs
        rr = jnp.repeat(jnp.arange(nbr), w)
        cc = self.block_cols.reshape(-1)
        blocks = self.data.reshape(-1, bs, bs)
        dense = jnp.zeros((nbr * bs, mpad), self.dtype)
        row_idx = (rr * bs)[:, None, None] + jnp.arange(bs)[None, :, None]
        col_idx = (cc * bs)[:, None, None] + jnp.arange(bs)[None, None, :]
        dense = dense.at[row_idx, col_idx].add(blocks)
        return dense[: self.n_rows_true, : self.n_cols_true]

    def tree_flatten(self):
        return (
            (self.data, self.block_cols),
            (self.n_rows_true, self.n_cols_true),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def bsr_from_scipy(
    a, block_size: int = 8, dtype=jnp.float32
) -> BsrMatrix:
    import scipy.sparse as sp

    a = _as_2d_scipy(a).tocsr()
    n, m = a.shape
    bs = block_size
    npad, mpad = _round_up(n, bs), _round_up(m, bs)
    if (npad, mpad) != (n, m):
        a = a.copy()
        a.resize((npad, mpad))
    ab = sp.bsr_matrix(a, blocksize=(bs, bs))
    ab.sum_duplicates()
    nbr = ab.indptr.shape[0] - 1
    per_row = np.diff(ab.indptr)
    w = max(int(per_row.max()) if nbr else 0, 1)
    data = np.zeros((nbr, w, bs, bs), np.dtype(dtype))
    cols = np.zeros((nbr, w), np.int32)
    rr = np.repeat(np.arange(nbr), per_row)
    kk = (
        np.arange(len(ab.indices), dtype=np.int64)
        - np.repeat(ab.indptr[:-1].astype(np.int64), per_row)
        if len(ab.indices)
        else np.zeros(0, np.int64)
    )
    data[rr, kk] = ab.data
    cols[rr, kk] = ab.indices
    return BsrMatrix(jnp.asarray(data), jnp.asarray(cols), n, m)


# ---------------------------------------------------------------------------
# DIA (generalized diagonal) — gather-free SpMV via shifted slices
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DiaMatrix(LinearOperator):
    """Diagonal-offset storage: y = sum_d data[d] * shift(x, offsets[d]).

    Offsets are static pytree aux-data, so each shifted read lowers to a
    static slice of a zero-padded x — no gather at all.  This answers the
    reference's `change_order(4)` vectorized-load trick
    (`ell_matrix.hpp:362`): contiguity by construction.
    """

    data: jax.Array  # (ndiag, n_rows_pad)
    offsets: tuple[int, ...]  # static
    n_rows_true: int
    n_cols_true: int

    @property
    def shape(self):
        return (self.n_rows_true, self.n_cols_true)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(np.prod(self.data.shape))

    def _halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    def mv(self, x: jax.Array) -> jax.Array:
        h = self._halo()
        npad = self.data.shape[1]
        xp = jnp.zeros(npad + 2 * h, x.dtype)
        xp = xp.at[h : h + x.shape[0]].set(x)
        y = jnp.zeros(npad, x.dtype)
        for d, off in enumerate(self.offsets):
            y = y + self.data[d] * jax.lax.dynamic_slice(xp, (h + off,), (npad,))
        return y[: self.n_rows_true]

    def mm(self, X: jax.Array) -> jax.Array:
        # X block-major (p, n)
        h = self._halo()
        npad = self.data.shape[1]
        p = X.shape[0]
        Xp = jnp.zeros((p, npad + 2 * h), X.dtype)
        Xp = Xp.at[:, h : h + X.shape[1]].set(X)
        Y = jnp.zeros((p, npad), X.dtype)
        for d, off in enumerate(self.offsets):
            Y = Y + self.data[d][None, :] * jax.lax.dynamic_slice(
                Xp, (0, h + off), (p, npad)
            )
        return Y[:, : self.n_rows_true]

    def to_dense(self) -> jax.Array:
        """Debug/introspection dense rebuild from the diagonal planes."""
        n, m = self.shape
        dense = jnp.zeros((n, m), self.dtype)
        rows = jnp.arange(n)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            ok = (cols >= 0) & (cols < m)
            dense = dense.at[
                jnp.where(ok, rows, 0), jnp.where(ok, cols, 0)
            ].add(jnp.where(ok, self.data[d][:n], 0.0))
        return dense

    def tree_flatten(self):
        return (self.data,), (self.offsets, self.n_rows_true, self.n_cols_true)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)


def dia_from_scipy(a, dtype=jnp.float32, row_pad: int = ROW_TILE) -> DiaMatrix:
    a = _as_2d_scipy(a).tocoo()
    a.sum_duplicates()
    n, m = a.shape
    offs = np.unique(a.col.astype(np.int64) - a.row.astype(np.int64))
    npad = _round_up(n, row_pad)
    data = np.zeros((len(offs), npad), np.dtype(dtype))
    pos = np.searchsorted(offs, a.col.astype(np.int64) - a.row)
    data[pos, a.row] = a.data  # (diagonal, row) pairs are unique
    return DiaMatrix(jnp.asarray(data), tuple(int(o) for o in offs), n, m)
