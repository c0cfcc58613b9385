"""Tall-skinny QR (TSQR) — communication-avoiding tall QR factorization.

The north-star block-Lanczos variant (BASELINE.json config 3) normalizes
each Krylov block with a QR factorization instead of the reference's
sqrtm(W^T W) (`block_lanczos.hpp:28-34`): numerically stronger when W is
ill-conditioned, since it never squares the condition number.

TSQR structure (two-level tree): split the n rows into c chunks, QR each
chunk in parallel (vmapped Householder), stack the c small R
factors, QR the (c*p, p) stack, and recombine.  On a row-sharded state
the same tree maps onto per-shard local QRs + one gathered (c*p, p)
reduction — O(p^2) communication instead of O(n).

Signs are normalized (diag(R) >= 0) so the factorization is unique and
deterministic across chunkings.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lanczos_tpu.ops.precision import HIGHEST


def _fix_signs(q, r):
    d = jnp.sign(jnp.diagonal(r, axis1=-2, axis2=-1))
    d = jnp.where(d == 0, 1.0, d).astype(r.dtype)
    return q * d[..., None, :], r * d[..., :, None]


@partial(jax.jit, static_argnames=("n_chunks",))
def tsqr(a: jax.Array, n_chunks: int = 8):
    """QR of a tall-skinny (n, p) matrix via a two-level reduction tree.

    Returns (q, r): q (n, p) with orthonormal columns, r (p, p) upper
    triangular with non-negative diagonal, a = q @ r.
    """
    n, p = a.shape
    c = max(1, min(n_chunks, n // max(p, 1)))
    rows = -(-n // c) * c
    a_pad = jnp.pad(a, ((0, rows - n), (0, 0)))
    blocks = a_pad.reshape(c, rows // c, p)

    q1, r1 = jax.vmap(partial(jnp.linalg.qr, mode="reduced"))(blocks)
    q2, r = jnp.linalg.qr(r1.reshape(c * p, p), mode="reduced")
    q2b = q2.reshape(c, p, p)
    q = jnp.einsum(
        "cij,cjk->cik", q1, q2b, preferred_element_type=a.dtype, precision=HIGHEST
    ).reshape(rows, p)[:n]
    q, r = _fix_signs(q, r)
    return q, r


def tsqr_sharded(x: jax.Array, mesh, axis: str = "rows"):
    """Communication-avoiding TSQR of a BLOCK-MAJOR (p, n) state sharded
    over its last axis: per-shard local QR, `all_gather` of the (p, p)
    R factors (O(p^2) traffic — not O(n)), a replicated QR of the
    (n_dev*p, p) stack, and a local (rows_loc, p) x (p, p) recombine.

    Returns (q, r): q (p, n) sharded like x with orthonormal rows over
    the global state, r (p, p) replicated upper-triangular with
    non-negative diagonal, x = r^T-combined q (tall convention
    x.T = q.T @ r).  Zero rows of x (padding/halo slots of the
    distributed padded state) come back zero in q up to rounding.
    """
    import numpy as np

    p = x.shape[0]
    n_dev = int(np.prod(mesh.devices.shape))

    def body(xb):  # (p, rows_loc)
        ql, rl = jnp.linalg.qr(xb.T, mode="reduced")  # (rows_loc,p),(p,p)
        rstack = jax.lax.all_gather(rl, axis)  # (n_dev, p, p)
        q2, r = jnp.linalg.qr(
            rstack.reshape(n_dev * p, p), mode="reduced"
        )
        my = jax.lax.axis_index(axis)
        q2b = jax.lax.dynamic_index_in_dim(
            q2.reshape(n_dev, p, p), my, 0, keepdims=False
        )
        q = jnp.einsum(
            "rp,pk->rk", ql, q2b, preferred_element_type=x.dtype, precision=HIGHEST
        )
        d = jnp.sign(jnp.diagonal(r))
        d = jnp.where(d == 0, 1.0, d).astype(r.dtype)
        return (q * d[None, :]).T, r * d[:, None]

    from jax.sharding import PartitionSpec as P

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(None, axis),
        out_specs=(P(None, axis), P()),
        check_vma=False,
    )(x)
