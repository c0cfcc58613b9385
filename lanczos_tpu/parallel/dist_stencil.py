"""Distributed stacked Maxwell operator: z-slab domain decomposition.

The stacked folded-plane state (6, Z, P) of `models/maxwell_stacked.py` is
sharded over the mesh ``rows`` axis along z.  Each shard stores
``[1 pad row | Zl interior rows | 1 pad row]`` (pads zero, so global dots
and norms need no masking), and one SpMV is

  1. `ppermute` ONE z-plane (6, 1, P) to each neighbor — O(plane) bytes,
     independent of n: the weak-scaling halo exchange;
  2. write the received planes into the pad rows (input copy only — the
     state keeps its zero-pad invariant);
  3. apply the stacked stencil to the local slab with this shard's
     z-weight slice.

Everything else (axpys, Gram matrices, norms) runs on the sharded global
array under jit with GSPMD-inserted psums, so `vector_lanczos` /
`block_lanczos` work unchanged.

Reference had no distributed backend; the analogous single-GPU machinery
is the launch-shape partitioning in `test_lanczos.cu:160-187`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lanczos_tpu.models.maxwell import maxwell_component_shapes
from lanczos_tpu.models.maxwell_stacked import apply_stacked, stacked_taps
from lanczos_tpu.ops.operator import LinearOperator
from lanczos_tpu.parallel.mesh import ROWS_AXIS


def _local_mv(u_loc, wz, wp, taps, axis):
    """Per-shard body: halo exchange one z-plane each way into the pad
    rows, then the stacked stencil on the local slab."""
    n_dev = jax.lax.axis_size(axis)
    zs = u_loc.shape[1]
    fwd = [(i, i + 1) for i in range(n_dev - 1)]
    bwd = [(i + 1, i) for i in range(n_dev - 1)]
    # my last interior row -> right neighbor's left pad; edges get zeros.
    from_left = jax.lax.ppermute(u_loc[:, zs - 2 : zs - 1], axis, fwd)
    from_right = jax.lax.ppermute(u_loc[:, 1:2], axis, bwd)
    u_work = jnp.concatenate(
        [from_left, u_loc[:, 1 : zs - 1], from_right], axis=1
    )
    # sharded z-weights arrive as (1, n_taps, Zs) per shard
    return apply_stacked(u_work, wz[0], wp, taps)


@jax.tree_util.register_pytree_node_class
class DistributedStackedMaxwell(LinearOperator):
    """Z-sharded stacked Maxwell operator over a 1-D device mesh."""

    def __init__(self, nx, ny, nz, weights, taps, mesh, zl, dtype_name):
        self.nx, self.ny, self.nz = nx, ny, nz
        # weights = (wz, wp): wz (n_dev, n_taps, Zs) row-sharded per-shard
        # z weights; wp (n_taps, P) replicated.
        self.wz, self.wplane = weights
        self.taps = taps
        self.mesh = mesh
        self.zl = zl  # interior z rows per shard
        self.zs = zl + 2  # stored rows per shard
        self.dtype_name = dtype_name
        self.comp_shapes = maxwell_component_shapes(nx, ny, nz)
        self.comp_sizes = tuple(int(np.prod(s)) for s in self.comp_shapes)
        self.n = int(sum(self.comp_sizes))
        self.xc = nx + 3
        self.yc = ny + 3
        self.plane = self.yc * self.xc
        self.axis = ROWS_AXIS

    @classmethod
    def create(
        cls, nx, ny, nz, mesh: Mesh, dtype=jnp.float32
    ) -> "DistributedStackedMaxwell":
        n_dev = int(np.prod(mesh.devices.shape))
        taps, wz_int, wp = stacked_taps(nx, ny, nz)
        z_ext = nz + 1  # max component z extent
        zl = -(-z_ext // n_dev)  # interior rows per shard
        full = np.zeros((len(taps), n_dev * zl))
        full[:, :z_ext] = wz_int
        # shard s stores global interior z in [s*zl, (s+1)*zl) at rows 1..zl
        wz = np.zeros((n_dev, len(taps), zl + 2))
        wz[:, :, 1 : 1 + zl] = full.reshape(len(taps), n_dev, zl).transpose(
            1, 0, 2
        )
        wdtype = jnp.promote_types(jnp.float32, dtype)
        weights = (
            jax.device_put(
                jnp.asarray(wz, wdtype),
                NamedSharding(mesh, P(ROWS_AXIS, None, None)),
            ),
            jax.device_put(jnp.asarray(wp, wdtype), NamedSharding(mesh, P())),
        )
        return cls(nx, ny, nz, weights, taps, mesh, zl, np.dtype(dtype).name)

    # -- properties ---------------------------------------------------------

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return jnp.dtype(self.dtype_name)

    @property
    def n_dev(self) -> int:
        return int(np.prod(self.mesh.devices.shape))

    @property
    def state_shape(self):
        # global stacked state: z = n_dev shard segments of Zs rows each
        return (6, self.n_dev * self.zs, self.plane)

    @property
    def state_pspec(self):
        """PartitionSpec of ONE state vector (no block axis): z-sharded.
        The Lanczos drivers prepend None axes for p / basis dims and pin
        the scan carry with it (keeps GSPMD from rematerializing)."""
        return P(None, self.axis, None)

    # -- compute ------------------------------------------------------------

    def _mapped(self, block: bool):
        spec_u = (
            P(None, None, self.axis, None) if block else P(None, self.axis, None)
        )
        fn = functools.partial(_local_mv, taps=self.taps, axis=self.axis)
        if block:
            inner = fn
            fn = lambda U, *w: jax.vmap(lambda u: inner(u, *w))(U)
        return jax.shard_map(
            fn,
            mesh=self.mesh,
            in_specs=(spec_u, P(self.axis, None, None), P()),
            out_specs=spec_u,
        )

    def mv(self, u: jax.Array) -> jax.Array:
        return self._mapped(False)(u, self.wz, self.wplane)

    def mm(self, U: jax.Array) -> jax.Array:
        return self._mapped(True)(U, self.wz, self.wplane)

    # -- state packing ------------------------------------------------------

    def _z_map(self, z: int) -> int:
        """Global interior z -> global storage z (shard segment layout)."""
        s, zloc = divmod(z, self.zl)
        return s * self.zs + 1 + zloc

    def pack(self, b) -> jax.Array:
        """Flat logical vector(s) -> sharded stacked state."""
        b = np.asarray(b, self.dtype)
        if b.ndim == 2:
            out = np.stack([self._pack1(x) for x in b])
            spec = P(None, None, self.axis, None)
        else:
            out = self._pack1(b)
            spec = P(None, self.axis, None)
        return jax.device_put(out, NamedSharding(self.mesh, spec))

    def _storage_rows(self, zl_c: int) -> np.ndarray:
        return np.asarray([self._z_map(z) for z in range(zl_c)])

    def _pack1(self, b: np.ndarray) -> np.ndarray:
        u = np.zeros((6, self.n_dev * self.zs, self.plane), self.dtype)
        o = 0
        for c, ((zl_c, yl, xl), sz) in enumerate(
            zip(self.comp_shapes, self.comp_sizes)
        ):
            comp = b[o : o + sz].reshape(zl_c, yl, xl)
            o += sz
            padded = np.zeros((zl_c, self.yc, self.xc), self.dtype)
            padded[:, 1 : 1 + yl, 1 : 1 + xl] = comp
            u[c, self._storage_rows(zl_c)] = padded.reshape(zl_c, self.plane)
        return u

    def unpack(self, u: jax.Array) -> np.ndarray:
        u = np.asarray(u)
        if u.ndim == 4:
            return np.stack([self.unpack(x) for x in u])
        parts = []
        for c, (zl_c, yl, xl) in enumerate(self.comp_shapes):
            rows = u[c, self._storage_rows(zl_c)].reshape(zl_c, self.yc, self.xc)
            parts.append(rows[:, 1 : 1 + yl, 1 : 1 + xl].reshape(-1))
        return np.concatenate(parts)

    def state_index(self, lc: int) -> tuple[int, int, int]:
        lc = int(lc)
        for c, (shape, sz) in enumerate(zip(self.comp_shapes, self.comp_sizes)):
            if lc < sz:
                zl_c, yl, xl = shape
                z, r = divmod(lc, yl * xl)
                y, x = divmod(r, xl)
                return (c, self._z_map(z), (1 + y) * self.xc + (1 + x))
            lc -= sz
        raise IndexError("lc out of range")

    def trace_fn(self, lc: int):
        c, zsg, ps = self.state_index(lc)
        return lambda q: q[..., c, zsg, ps]

    # -- pytree -------------------------------------------------------------

    def tree_flatten(self):
        return (self.wz, self.wplane), (
            self.nx, self.ny, self.nz, self.taps, self.mesh, self.zl,
            self.dtype_name,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        nx, ny, nz, taps, mesh, zl, dtype_name = aux
        return cls(nx, ny, nz, tuple(children), taps, mesh, zl, dtype_name)
