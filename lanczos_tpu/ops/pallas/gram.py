"""Multi-operand tall-skinny Gram product as a Pallas kernel on the Triton
route.

``gram(cat(xs), z)[k, j] = <cat(xs)[k], z[j]>`` over all state axes, plus
optionally ``gram(z, z)``, from ONE read of every operand.  XLA lowers each
``einsum("p...,q...->pq")`` to its own GEMM with M, N <= 16 and K ~ 1e8, so
k operands against one z re-read z k times (or concatenate first, one extra
pass).

The design follows the reference's `mm_tt` / `mm_tt2` Gram kernels
(`kernels/mm_tt.hpp:77-148`): each program walks a contiguous run of rows,
loads a row tile of every operand (masked: the tile length and the padded
block widths are powers of two), and accumulates the K x p outer products by
broadcast multiply in registers.  Where the reference finishes with an
``atomicAdd`` into the p x p result, each program here writes its own
(K, p) partial and a second pass sums them, so the result does not depend on
the order the programs ran in.  No ``pl.dot``: on f32 inputs it would run in
TF32, and p < 16 is below its minimum shape.

Accumulation is in ``acc_dtype``: float32, or float64 for the compensated
(f64-accurate) Gram from f32 storage.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Accumulator elements per program (sum of P_i * Pz * tile): keeps the
# register tile at ~64 per thread with 4 warps.
_ACC_BUDGET = 8192
_NUM_WARPS = 4
# Programs per launch: enough to fill every SM several times over.
_MAX_PROGRAMS = 1056


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _row_tile(widths, pz: int) -> int:
    per_row = sum(w * pz for w in widths)
    t = 1 << max((_ACC_BUDGET // per_row).bit_length() - 1, 0)
    return int(min(max(t, 16), 4096))


def _kernel(*refs, ps, p, n, n_iter, tile, acc_dtype, include_zz):
    nx = len(ps)
    x_refs, z_ref, out_ref = refs[:nx], refs[nx], refs[nx + 1]
    pz = _pow2(p)
    widths = [_pow2(q) for q in ps] + ([pz] if include_zz else [])
    g = pl.program_id(0)
    cols = jnp.arange(tile, dtype=jnp.int32)

    def load(ref, rows_true, width, c, cmask):
        r = jnp.arange(width, dtype=jnp.int32)
        mask = (r[:, None] < rows_true) & cmask[None, :]
        v = plgpu.load(
            ref.at[r[:, None] * n + c[None, :]], mask=mask, other=0.0,
            eviction_policy="evict_first",
        )
        return v.astype(acc_dtype)

    def body(it, accs):
        c = (g * n_iter + it) * tile + cols
        cmask = c < n
        zv = load(z_ref, p, pz, c, cmask)  # (Pz, T)
        ops = [load(x_refs[i], ps[i], widths[i], c, cmask) for i in range(nx)]
        if include_zz:
            ops.append(zv)
        return tuple(
            acc + v[:, None, :] * zv[None, :, :] for acc, v in zip(accs, ops)
        )

    init = tuple(jnp.zeros((w, pz, tile), acc_dtype) for w in widths)
    accs = jax.lax.fori_loop(0, n_iter, body, init)
    base = g * sum(widths) * pz
    off = 0
    for acc, w in zip(accs, widths):
        r = jnp.arange(w, dtype=jnp.int32)
        j = jnp.arange(pz, dtype=jnp.int32)
        idx = base + (off + r[:, None]) * pz + j[None, :]
        plgpu.store(out_ref.at[idx], jnp.sum(acc, axis=-1))
        off += w


def triton_grams(
    xs, z: jax.Array, *, include_zz: bool = False, acc_dtype=jnp.float32,
    interpret: bool = False,
) -> jax.Array:
    """(K, p) Gram blocks [gram(x_0, z); ...; gram(z, z) if include_zz] in
    `acc_dtype`.  xs: tuple of (p_i, *state); z: (p, *state), one dtype."""
    xs = tuple(xs)
    p = z.shape[0]
    n = z.size // p
    ps = tuple(x.shape[0] for x in xs)
    if max(ps + (p,)) * n >= 2**31:
        raise ValueError("operand larger than 2**31 elements: int32 offsets")
    pz = _pow2(p)
    widths = [_pow2(q) for q in ps] + ([pz] if include_zz else [])
    tile = _row_tile(widths, pz)
    n_tiles = pl.cdiv(n, tile)
    n_iter = pl.cdiv(n_tiles, _MAX_PROGRAMS)
    grid = pl.cdiv(n_tiles, n_iter)
    kp = sum(widths)
    kernel = functools.partial(
        _kernel, ps=ps, p=p, n=n, n_iter=n_iter, tile=tile,
        acc_dtype=jnp.dtype(acc_dtype), include_zz=include_zz,
    )
    flat = [x.reshape(-1) for x in xs] + [z.reshape(-1)]
    part = pl.pallas_call(
        kernel,
        grid=(grid,),
        out_shape=jax.ShapeDtypeStruct((grid * kp * pz,), acc_dtype),
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="block_grams",
    )(*flat)
    tot = jnp.sum(part.reshape(grid, kp, pz), axis=0)
    blocks, off = [], 0
    for q, w in zip(ps + ((p,) if include_zz else ()), widths):
        blocks.append(tot[off : off + q, :p])
        off += w
    return jnp.concatenate(blocks, axis=0)
