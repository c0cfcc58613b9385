"""Block-dense products around the SpMM: multi-operand mix and multi-Gram.

The dense block math of a Lanczos iteration — Gram products (reference
`kernels/mm_tt.hpp` / `mm_tt2.hpp`) and tall x small basis updates
(`mm_ts.hpp`) — is memory-bound: p <= 18 columns over 1e7..1e8-row states.
The fused recurrence (`methods/block_lanczos_fused.py`) needs each only
once per iteration, reading every operand once:

* ``block_mix(coeffs, xs)`` — out[j] = sum_k coeffs[k, j] * cat(xs)[k]
  (the reference's fused ``mm_ts2`` update generalized to any linear
  recombination of several block operands, `mm_ts.hpp:110`);
* ``block_grams(xs, z)``   — gram(cat(xs), z), optionally with gram(z, z).

Operands are block-major (p_i, *state) arrays of one state shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lanczos_tpu.ops.precision import HIGHEST


def block_mix(coeffs: jax.Array, xs) -> jax.Array:
    """out[j] = sum_k coeffs[k, j] * cat(xs, axis=0)[k].

    coeffs: (K, p_out) with K the summed leading dims of xs.  Written as
    one scalar multiply-add chain per output row, stacked: XLA fuses the
    p_out chains into one multi-output loop that reads each operand row
    once.  A (p_out, *state) broadcast product instead re-reads every
    operand once per output row, and a K x p_out einsum goes to GEMM
    calls; on the H100 at N=160, p=4 these ran 2.4x and 3.1x slower
    (PERF.md)."""
    xs = tuple(xs)
    dtype = xs[0].dtype
    cdt = jnp.promote_types(jnp.float32, dtype)
    rows = [row for x in xs for row in x]
    if coeffs.shape[0] != len(rows):
        raise ValueError(f"coeffs {coeffs.shape} vs operands "
                         f"{[x.shape for x in xs]}")
    c = coeffs.astype(cdt)
    outs = []
    for j in range(c.shape[1]):
        acc = c[0, j] * rows[0].astype(cdt)
        for k in range(1, len(rows)):
            acc = acc + c[k, j] * rows[k].astype(cdt)
        outs.append(acc.astype(dtype))
    return jnp.stack(outs)


def gram_reference(xs, z, include_zz=False, acc_dtype=None) -> jax.Array:
    """Plain jnp Gram blocks at precision HIGHEST, accumulated in
    acc_dtype: the CPU's implementation and the GPU kernel's reference."""
    acc = _acc_dtype(z, acc_dtype)
    ops = list(xs) + ([z] if include_zz else [])
    zc = z.astype(acc)
    return jnp.concatenate([
        jnp.einsum("k...,j...->kj", x.astype(acc), zc,
                   preferred_element_type=acc, precision=HIGHEST)
        for x in ops
    ])


def block_grams(xs, z: jax.Array, include_zz: bool = False,
                acc_dtype=None) -> jax.Array:
    """(K, p) = [gram(x_0, z); gram(x_1, z); ...; gram(z, z) if include_zz].

    acc_dtype defaults to promote(float32, z.dtype); float64 gives Gram
    blocks accurate to f64 rounding from f32 storage (needs
    jax_enable_x64).  The implementation is chosen by platform: the GPU
    runs the Triton-route kernel (`ops/pallas/gram.py`, one read of each
    operand), the CPU the plain jnp contraction."""
    acc = _acc_dtype(z, acc_dtype)
    platform = jax.default_backend()
    if platform == "gpu":
        from lanczos_tpu.ops.pallas.gram import triton_grams

        return triton_grams(xs, z, include_zz=include_zz, acc_dtype=acc)
    if platform == "cpu":
        return gram_reference(xs, z, include_zz, acc)
    raise NotImplementedError(f"block_grams: no implementation for {platform!r}")


def _acc_dtype(z, acc_dtype):
    acc = jnp.dtype(acc_dtype or jnp.promote_types(jnp.float32, z.dtype))
    if acc == jnp.float64 and not jax.config.read("jax_enable_x64"):
        raise ValueError("float64 Gram accumulation needs jax_enable_x64")
    return acc
