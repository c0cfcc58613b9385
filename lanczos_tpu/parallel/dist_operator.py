"""Row-sharded sparse operators for multi-chip Lanczos.

The scaling axis the reference lacks (SURVEY.md §2
"Distributed backend: none"): the operator's rows and every Krylov vector
are partitioned over a 1-D device mesh, and the SpMV/SpMM runs under
`shard_map` with explicit collectives:

* `HaloShardedEll` — for banded matrices (all the reference fixtures:
  Maxwell curl operator, Laplacians).  Each shard stores its row block as
  ELL with indices *relative to a halo-extended local window*; one
  `ppermute` per neighbor exchanges the boundary entries of x, then the
  SpMV is purely local.  Communication per step: O(halo), independent of n
  — the design that gives weak scaling.
* `GatherShardedEll` — format-general fallback for arbitrary sparsity:
  `all_gather` the input vector (tiled), gather locally.  O(n)
  communication, still fully overlappable by XLA.

Everything downstream (dot products, Gram matrices, vector updates in the
`lax.scan` Lanczos bodies) operates on the sharded global arrays under
`jit`, where GSPMD partitions the elementwise work per shard and inserts
`psum` all-reduces for the reductions — so the existing `vector_lanczos` /
`block_lanczos` run unchanged on these operators.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from lanczos_tpu.ops.precision import HIGHEST
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lanczos_tpu.ops.formats import _as_2d_scipy, _ell_planes, _round_up, ROW_TILE
from lanczos_tpu.ops.operator import LinearOperator
from lanczos_tpu.parallel.mesh import ROWS_AXIS, row_sharding


def _shard_rows(b: np.ndarray, n_padded: int, mesh, axis) -> jax.Array:
    """Zero-pad the last (row) axis of a host array to n_padded and place
    it row-sharded over the mesh."""
    pad = [(0, 0)] * (b.ndim - 1) + [(0, n_padded - b.shape[-1])]
    spec = P(axis) if b.ndim == 1 else P(None, axis)
    return jax.device_put(np.pad(b, pad), NamedSharding(mesh, spec))


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


# ---------------------------------------------------------------------------
# Halo-exchange banded operator
# ---------------------------------------------------------------------------


def _halo_exchange(x, axis, halo):
    """Build the halo-extended local window ``[halo | local | halo]``.

    Single-hop (halo <= rows_loc, the common banded case) sends exactly
    `halo` boundary rows to each neighbor via one `ppermute` pair.  Wider
    bands fall back to multi-hop exchange: k-th neighbors contribute whole
    blocks (the outermost could be sliced — not worth the extra op at these
    hop counts), and the static center slice trims to rows_loc + 2*halo.
    Unpaired ppermute targets (mesh edges) receive zeros, which is exactly
    the matrix's zero boundary.
    """
    if halo == 0:
        return x
    n_dev = jax.lax.axis_size(axis)
    rows_loc = x.shape[0]
    hops = -(-halo // rows_loc)
    if hops == 1:
        fwd = [(i, i + 1) for i in range(n_dev - 1)]
        bwd = [(i + 1, i) for i in range(n_dev - 1)]
        from_left = jax.lax.ppermute(x[-halo:], axis, fwd)
        from_right = jax.lax.ppermute(x[:halo], axis, bwd)
        return jnp.concatenate([from_left, x, from_right], axis=0)
    parts = []
    for k in range(hops, 0, -1):
        fwd = [(i, i + k) for i in range(n_dev - k)]
        parts.append(jax.lax.ppermute(x, axis, fwd))
    parts.append(x)
    for k in range(1, hops + 1):
        bwd = [(i + k, i) for i in range(n_dev - k)]
        parts.append(jax.lax.ppermute(x, axis, bwd))
    ext = jnp.concatenate(parts, axis=0)
    start = hops * rows_loc - halo
    return jax.lax.slice_in_dim(ext, start, start + rows_loc + 2 * halo, axis=0)


def _halo_mv_local(data, idx, x, axis, halo):
    """Per-shard body: halo exchange, then ELL-gather from the extended
    window.  x: (rows_loc,) or block-major (p, rows_loc)."""
    if x.ndim == 1:
        x_ext = _halo_exchange(x, axis, halo)
        gathered = jnp.take(x_ext, idx, axis=0)  # (rows_loc, w)
        return jnp.sum(data * gathered, axis=1)
    x_ext = _halo_exchange(jnp.swapaxes(x, 0, 1), axis, halo)  # (ext, p)
    gathered = jnp.take(x_ext, idx, axis=0)  # (rows_loc, w, p)
    return jnp.einsum(
        "rw,rwp->pr", data, gathered, preferred_element_type=data.dtype, precision=HIGHEST
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class HaloShardedEll(LinearOperator):
    """Row-sharded banded ELL; SpMV = ppermute halo exchange + local gather.

    `data`/`indices` are global (n_pad, width) arrays sharded over rows;
    inside `shard_map` each device sees its (rows_loc, width) block whose
    indices address the halo-extended local x window
    ``[left_halo | local | right_halo]``.
    """

    data: jax.Array  # (n_pad, width), row-sharded
    indices: jax.Array  # (n_pad, width) int32, local-window indices
    mesh: Mesh  # static
    halo: int  # static
    n_rows_true: int
    axis: str = ROWS_AXIS
    # Optional symmetric bandwidth-reducing permutation (RCM): the stored
    # matrix is A[perm][:, perm].  Kept as a hashable tuple so it can live
    # in pytree aux-data; None when the natural ordering was banded enough.
    perm: tuple[int, ...] | None = None

    @property
    def shape(self):
        return (self.n_rows_true, self.n_rows_true)

    @property
    def state_pspec(self):
        """PartitionSpec of ONE (flat) state vector: row-sharded."""
        return P(self.axis)

    @property
    def n_padded(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(np.prod(self.data.shape))

    def _mapped(self, ndim):
        spec = P(self.axis) if ndim == 1 else P(None, self.axis)
        return _shard_map(
            functools.partial(_halo_mv_local, axis=self.axis, halo=self.halo),
            self.mesh,
            in_specs=(P(self.axis, None), P(self.axis, None), spec),
            out_specs=spec,
        )

    def mv(self, x: jax.Array) -> jax.Array:
        return self._mapped(1)(self.data, self.indices, x)

    def mm(self, X: jax.Array) -> jax.Array:
        return self._mapped(2)(self.data, self.indices, X)

    # -- helpers ------------------------------------------------------------

    def pad_vector(self, b) -> jax.Array:
        """Permute (if reordered), zero-pad to n_padded, and shard.
        b: (n,) or block-major (p, n).  Done on the host, so no device
        ever holds the whole block."""
        b = np.asarray(b, self.dtype)
        if self.perm is not None:
            b = np.take(b, np.asarray(self.perm), axis=-1)
        return _shard_rows(b, self.n_padded, self.mesh, self.axis)

    def unpad_vector(self, y) -> jax.Array:
        """Inverse of pad_vector: back to natural ordering and true length."""
        row_ax = y.ndim - 1
        y = jax.lax.slice_in_dim(y, 0, self.n_rows_true, axis=row_ax)
        if self.perm is not None:
            inv = np.argsort(np.asarray(self.perm))
            y = jnp.take(y, jnp.asarray(inv, jnp.int32), axis=row_ax)
        return y

    def local_index(self, i: int) -> int:
        """Position of natural-ordering index i in the operator's (possibly
        permuted) row space — use for receiver/trace indices (lc)."""
        if self.perm is None:
            return i
        return int(np.argsort(np.asarray(self.perm))[i])

    def tree_flatten(self):
        return (self.data, self.indices), (
            self.mesh,
            self.halo,
            self.n_rows_true,
            self.axis,
            self.perm,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def _shard_halo(a, rows_loc: int) -> int:
    """Max distance any row's column reaches outside its own shard."""
    coo = a.tocoo()
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    r0 = (r // rows_loc) * rows_loc
    return int(
        max(
            np.maximum(r0 - c, 0).max(initial=0),
            np.maximum(c - (r0 + rows_loc) + 1, 0).max(initial=0),
        )
    )


def halo_sharded_ell(
    a,
    mesh: Mesh,
    dtype=jnp.float32,
    axis: str = ROWS_AXIS,
    reorder: str = "auto",
) -> HaloShardedEll:
    """Build a HaloShardedEll from a scipy matrix (host-side assembly).

    `reorder`: "none" keeps the natural row order; "rcm" applies a
    symmetric reverse-Cuthill-McKee bandwidth-reducing permutation (the
    analogue of the reference's `change_order` data-layout pass,
    `ell_matrix.hpp:362` — reshaping for locality before the hot loop);
    "auto" applies RCM only when the natural ordering would need
    multi-hop halos.  Raises when even the reordered matrix would need
    halos spanning most of the mesh — use `gather_sharded_ell` then.
    """
    a = _as_2d_scipy(a).tocsr()
    a.sum_duplicates()
    n, m = a.shape
    if n != m:
        raise ValueError("operator must be square")
    if reorder not in ("none", "rcm", "auto"):
        raise ValueError(f"unknown reorder={reorder!r}")
    n_dev = int(np.prod(mesh.devices.shape))
    rows_loc = _round_up(-(-n // n_dev), ROW_TILE)
    n_pad = rows_loc * n_dev

    perm = None
    halo = _shard_halo(a, rows_loc)
    if reorder == "rcm" or (reorder == "auto" and halo > rows_loc):
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        p = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
        a = a[p][:, p].tocsr()
        a.sum_duplicates()
        perm = tuple(int(i) for i in p)
        halo = _shard_halo(a, rows_loc)
    hops = -(-halo // rows_loc) if halo else 0
    # _halo_exchange reaches k-th neighbors for k = 1..n_dev-1, so any
    # hops <= n_dev - 1 is feasible (hops == 1 on a 2-device mesh is the
    # ordinary nearest-neighbor ppermute).
    if hops >= n_dev:
        raise ValueError(
            f"halo={halo} needs {hops} neighbor hops on a {n_dev}-device "
            "mesh even after reordering — use gather_sharded_ell"
        )

    per_row = np.diff(a.indptr)
    w = max(int(per_row.max(initial=0)), 1)

    from lanczos_tpu import native

    packed = None
    if np.dtype(dtype) == np.float32:
        packed = native.halo_ell_from_csr(
            a.indptr, a.indices, a.data, n, n_pad, w, rows_loc, halo
        )
    if packed is not None:
        data, idx = packed
    else:
        # columns relative to the row's halo-extended shard window
        base = (np.arange(n, dtype=np.int64) // rows_loc) * rows_loc
        data, idx = _ell_planes(a, n_pad, w, dtype, col_shift=base - halo)
    sh = NamedSharding(mesh, P(axis, None))
    return HaloShardedEll(
        jax.device_put(jnp.asarray(data), sh),
        jax.device_put(jnp.asarray(idx), sh),
        mesh,
        halo,
        n,
        axis,
        perm,
    )


# ---------------------------------------------------------------------------
# All-gather fallback operator (arbitrary sparsity)
# ---------------------------------------------------------------------------


def _gather_mv_local(data, idx, x, axis):
    if x.ndim == 1:
        x_full = jax.lax.all_gather(x, axis, tiled=True)  # (n_pad,)
        gathered = jnp.take(x_full, idx, axis=0)
        return jnp.sum(data * gathered, axis=1)
    # block-major (p, rows_loc): gather columns
    x_full = jax.lax.all_gather(x, axis, axis=1, tiled=True)  # (p, n_pad)
    gathered = jnp.take(x_full, idx, axis=1)  # (p, rows_loc, w)
    return jnp.einsum(
        "rw,prw->pr", data, gathered, preferred_element_type=data.dtype, precision=HIGHEST
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class GatherShardedEll(LinearOperator):
    """Row-sharded ELL with global column indices; SpMV all-gathers x."""

    data: jax.Array  # (n_pad, width), row-sharded
    indices: jax.Array  # (n_pad, width) int32 global columns
    mesh: Mesh
    n_rows_true: int
    axis: str = ROWS_AXIS

    @property
    def shape(self):
        return (self.n_rows_true, self.n_rows_true)

    @property
    def state_pspec(self):
        """PartitionSpec of ONE (flat) state vector: row-sharded."""
        return P(self.axis)

    @property
    def n_padded(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(np.prod(self.data.shape))

    def _mapped(self, ndim):
        spec = P(self.axis) if ndim == 1 else P(None, self.axis)
        return _shard_map(
            functools.partial(_gather_mv_local, axis=self.axis),
            self.mesh,
            in_specs=(P(self.axis, None), P(self.axis, None), spec),
            out_specs=spec,
        )

    def mv(self, x: jax.Array) -> jax.Array:
        return self._mapped(1)(self.data, self.indices, x)

    def mm(self, X: jax.Array) -> jax.Array:
        return self._mapped(2)(self.data, self.indices, X)

    def pad_vector(self, b) -> jax.Array:
        """b: (n,) or block-major (p, n); pads/shard the row axis (last)."""
        return _shard_rows(
            np.asarray(b, self.dtype), self.n_padded, self.mesh, self.axis
        )

    def tree_flatten(self):
        return (self.data, self.indices), (self.mesh, self.n_rows_true, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def gather_sharded_ell(
    a, mesh: Mesh, dtype=jnp.float32, axis: str = ROWS_AXIS
) -> GatherShardedEll:
    a = _as_2d_scipy(a).tocsr()
    a.sum_duplicates()
    n, m = a.shape
    if n != m:
        raise ValueError("operator must be square")
    n_dev = int(np.prod(mesh.devices.shape))
    rows_loc = _round_up(-(-n // n_dev), ROW_TILE)
    n_pad = rows_loc * n_dev
    per_row = np.diff(a.indptr)
    w = max(int(per_row.max(initial=0)), 1)
    data, idx = _ell_planes(a, n_pad, w, dtype)
    sh = NamedSharding(mesh, P(axis, None))
    return GatherShardedEll(
        jax.device_put(jnp.asarray(data), sh),
        jax.device_put(jnp.asarray(idx), sh),
        mesh,
        n,
        axis,
    )
