"""Maxwell operator on the stacked folded-plane state.

The state vector is not a flat (n,) array but one stacked tensor
``(6, Zc, P)``: six field components, z as the major axis, and the (y, x)
plane folded into the minor axis (P = (ny+3) * (nx+3)).  Component
interiors sit at offset (z=Z_OFF, y=1, x=1) inside zero pads, so in this
layout

  * an x-shift by +-1 is a roll by -+1 along the folded plane,
  * a y-shift by +-1 is a roll by -+(nx+3),
  * a z-shift by +-1 is a one-row shift along z,

and every shifted read lands on a zero pad or a zero weight outside the
interior: no gathers, no index planes.  Each of the 24 taps of A (see
`models/maxwell.py`) is one shifted read times a separable weight, one
(Zc,) z-row and one (P,) plane row.  Same operator A = D @ diag(w) as
`MaxwellOperator` to rounding (cross-validated in tests); the distributed
form (`parallel/dist_stencil.py`) shards this layout along z.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lanczos_tpu.models.maxwell import _build_taps, maxwell_component_shapes
from lanczos_tpu.ops.operator import LinearOperator

Z_OFF = 1  # z-storage row of the first interior plane


def stacked_taps(nx: int, ny: int, nz: int):
    """Static taps ((out_c, in_c, dz, roll), ...), the interior z-weights
    (n_taps, nz+1) (zero past each component's z extent) and the plane
    weights (n_taps, P) of the stacked layout, all in float64."""
    descs, arrays = _build_taps(nx, ny, nz, np.float64)
    shapes = maxwell_component_shapes(nx, ny, nz)
    xc, yc = nx + 3, ny + 3
    plane = yc * xc
    taps, wz, wp = [], [], []
    for (out_c, in_c, ax, off), (wz_l, wy_l, wx_l) in zip(descs, arrays):
        zlen, ylen, xlen = shapes[out_c]
        row_z = np.zeros(nz + 1)
        row_z[:zlen] = wz_l
        w2 = np.zeros((yc, xc))
        w2[1 : 1 + ylen, 1 : 1 + xlen] = np.outer(wy_l, wx_l)
        if ax == 0:
            dz, roll = off, 0
        elif ax == 1:
            dz, roll = 0, (-off * xc) % plane
        else:
            dz, roll = 0, (-off) % plane
        taps.append((out_c, in_c, dz, roll))
        wz.append(row_z)
        wp.append(w2.reshape(-1))
    return tuple(taps), np.stack(wz), np.stack(wp)


def apply_stacked(u: jax.Array, wz: jax.Array, wplane: jax.Array, taps):
    """A @ u on one stacked state u: (6, Zc, P); wz: (n_taps, Zc) z-weights
    in storage rows, wplane: (n_taps, P).  Rows outside [0, Zc) read as
    zero.  Weights and accumulation in promote(float32, u.dtype); the
    result is cast back to u.dtype."""
    zc = u.shape[1]
    cdt = jnp.promote_types(jnp.float32, u.dtype)
    upad = jnp.pad(u, ((0, 0), (1, 1), (0, 0)))
    outs = []
    for oc in range(u.shape[0]):
        acc = None
        for t, (o, ic, dz, roll) in enumerate(taps):
            if o != oc:
                continue
            v = upad[ic, 1 + dz : 1 + dz + zc].astype(cdt)
            if roll:
                v = jnp.roll(v, roll, axis=1)
            term = v * wplane[t][None, :] * wz[t][:, None]
            acc = term if acc is None else acc + term
        outs.append(acc.astype(u.dtype))
    return jnp.stack(outs)


@jax.tree_util.register_pytree_node_class
class StackedMaxwellOperator(LinearOperator):
    """A = D @ diag(w) as 24 shifted reads of the stacked (6, Zc, P) state."""

    def __init__(self, nx, ny, nz, weights, taps, dtype_name="float32"):
        self.nx, self.ny, self.nz = nx, ny, nz
        self.wz, self.wplane = weights  # (n_taps, Zc), (n_taps, P)
        self.taps = taps
        self.dtype_name = dtype_name
        self.comp_shapes = maxwell_component_shapes(nx, ny, nz)
        self.comp_sizes = tuple(int(np.prod(s)) for s in self.comp_shapes)
        self.n = int(sum(self.comp_sizes))
        self.xc = nx + 3
        self.yc = ny + 3
        self.zc = nz + 1 + 2 * Z_OFF
        self.plane = self.yc * self.xc

    @classmethod
    def create(
        cls, nx: int, ny: int, nz: int, dtype=jnp.float32
    ) -> "StackedMaxwellOperator":
        """dtype=bfloat16 halves the state's bytes; weights stay f32 and
        accumulation is f32, cast once on store (~1e-2 relative operator
        error from input quantization — use f32 when Lanczos
        orthogonality matters)."""
        taps, wz_int, wp = stacked_taps(nx, ny, nz)
        wdtype = jnp.promote_types(jnp.float32, dtype)
        wz = np.zeros((len(taps), nz + 1 + 2 * Z_OFF))
        wz[:, Z_OFF : Z_OFF + nz + 1] = wz_int
        weights = (jnp.asarray(wz, wdtype), jnp.asarray(wp, wdtype))
        return cls(nx, ny, nz, weights, taps, np.dtype(dtype).name)

    # -- LinearOperator interface ------------------------------------------

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return jnp.dtype(self.dtype_name)

    @property
    def state_shape(self):
        return (6, self.zc, self.plane)

    def mv(self, u: jax.Array) -> jax.Array:
        return apply_stacked(u, self.wz, self.wplane, self.taps)

    # -- state packing ------------------------------------------------------

    def pack(self, b) -> jax.Array:
        """Flat logical vector(s) -> stacked state.  b: (n,) -> (6, Zc, P);
        block-major (p, n) -> (p, 6, Zc, P)."""
        b = jnp.asarray(b, self.dtype)
        if b.ndim == 2:
            return jax.vmap(self.pack)(b)
        planes = []
        o = 0
        for (zl, yl, xl), sz in zip(self.comp_shapes, self.comp_sizes):
            comp = b[o : o + sz].reshape(zl, yl, xl)
            o += sz
            comp = jnp.pad(
                comp,
                ((Z_OFF, self.zc - Z_OFF - zl), (1, self.yc - 1 - yl),
                 (1, self.xc - 1 - xl)),
            )
            planes.append(comp.reshape(self.zc, self.plane))
        return jnp.stack(planes)

    def unpack(self, u: jax.Array) -> jax.Array:
        """Stacked state -> flat logical vector(s)."""
        if u.ndim == 4:
            return jax.vmap(self.unpack)(u)
        parts = []
        for c, (zl, yl, xl) in enumerate(self.comp_shapes):
            comp = u[c].reshape(self.zc, self.yc, self.xc)
            parts.append(
                comp[Z_OFF : Z_OFF + zl, 1 : 1 + yl, 1 : 1 + xl].reshape(-1)
            )
        return jnp.concatenate(parts)

    def state_index(self, lc: int) -> tuple[int, int, int]:
        """Stacked-state coordinates (comp, z_storage, plane_pos) of the
        logical flat index lc — feed to `trace_fn`."""
        lc = int(lc)
        for c, (shape, sz) in enumerate(zip(self.comp_shapes, self.comp_sizes)):
            if lc < sz:
                zl, yl, xl = shape
                z, r = divmod(lc, yl * xl)
                y, x = divmod(r, xl)
                return (c, Z_OFF + z, (1 + y) * self.xc + (1 + x))
            lc -= sz
        raise IndexError("lc out of range")

    def trace_fn(self, lc: int):
        """Receiver extractor for the Lanczos methods: q[..., c, zs, ps]."""
        c, zs, ps = self.state_index(lc)
        return lambda q: q[..., c, zs, ps]

    # -- pytree -------------------------------------------------------------

    def tree_flatten(self):
        return (self.wz, self.wplane), (
            self.nx, self.ny, self.nz, self.taps, self.dtype_name,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        nx, ny, nz, taps, dtype_name = aux
        return cls(nx, ny, nz, tuple(children), taps, dtype_name)
