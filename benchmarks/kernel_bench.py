"""Per-kernel micro-benchmarks on the GPU, mirroring the reference's
measurement drivers (`source/kernels/measurements/*.cu`, SURVEY.md §2 #23):
Gram products `mm_tt` (XLA's einsum and the Triton-route kernel), the
tall x small update `mm_ts` (block mix), SpMM (gathered ELL, DIA, the
Maxwell stencil in both state layouts), the small-eig `sqrtm`, and the
fused against the materialized block iteration, swept over the
reference's N_COL = [2 4 6 8 10 12 14 16 18] where applicable.

Timing: host clock around work that ends in `block_until_ready`, best of
several calls after a compiling warm-up (`lanczos_tpu.utils.timing`).
Byte models count each operand once (the least traffic the operation
needs), so GB/s reads against the copy rate measured in the same run.

Usage: python benchmarks/kernel_bench.py [--only gram,sqrtm] [--json out]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lanczos_tpu.utils.timing import per_iteration, steady  # noqa: E402

NCOLS = [2, 4, 6, 8, 10, 12, 14, 16, 18]


def _row(p, seconds, bytes_moved, **extra):
    return {"n_col": p, "seconds": seconds,
            "gbps": bytes_moved / seconds / 1e9, **extra}


def bench_copy(rows: int, dtype=jnp.float32):
    """x + 1 over (p, rows) states: the read+write rate to compare with."""
    out = []
    for p in (1, 4, 16):
        x = jax.random.normal(jax.random.PRNGKey(0), (p, rows), dtype)
        s = steady(jax.jit(lambda x: x + 1), x)
        out.append(_row(p, s, 2 * x.nbytes))
    return out


def bench_gram(rows: int, dtype=jnp.float32, ncols=NCOLS):
    """[gram(q, v); gram(v, v)] (reference mm_tt / mm_tt2) through XLA's
    einsum and through the Triton-route kernel (GPU only)."""
    from lanczos_tpu.ops.block_dense import block_grams, gram_reference

    out = []
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    for p in ncols:
        q = jax.random.normal(k1, (p, rows), dtype)
        v = jax.random.normal(k2, (p, rows), dtype)
        xla = steady(jax.jit(lambda q, v: gram_reference((q,), v, True)), q, v)
        row = {"xla_seconds": xla,
               "xla_gbps": 2 * q.nbytes / xla / 1e9}
        if jax.default_backend() == "gpu":
            s = steady(jax.jit(lambda q, v: block_grams((q,), v, True)), q, v)
            row.update(kernel_seconds=s, kernel_gbps=2 * q.nbytes / s / 1e9)
        out.append({"n_col": p, **row})
    return out


def bench_mix(rows: int, dtype=jnp.float32, ncols=NCOLS):
    """q = block_mix(E, (u1, u2, u3)) (reference mm_ts2 generalized)."""
    from lanczos_tpu.ops.block_dense import block_mix

    out = []
    key = jax.random.PRNGKey(0)
    for p in ncols:
        xs = tuple(jax.random.normal(jax.random.fold_in(key, i), (p, rows),
                                     dtype) for i in range(3))
        e = jax.random.normal(key, (3 * p, p), dtype)
        s = steady(jax.jit(lambda e, xs: block_mix(e, xs)), e, xs)
        out.append(_row(p, s, 4 * xs[0].nbytes))
    return out


def bench_sqrtm(dtype=jnp.float32, backend: str = "jacobi"):
    """sqrtm + inv-sqrtm of one N_COL x N_COL SPD matrix (reference
    my_sqrtm_cusolver.hpp / cuSOLVER syevjBatched)."""
    from lanczos_tpu.ops.smalleig import sqrtm_invsqrtm

    out = []
    key = jax.random.PRNGKey(0)
    for p in NCOLS:
        g = jax.random.normal(key, (256, p), dtype)
        a = g.T @ g + p * jnp.eye(p, dtype=dtype)
        a = a / jnp.trace(a)
        f = jax.jit(lambda a: sqrtm_invsqrtm(a, backend=backend))
        out.append({"n_col": p, "seconds": steady(f, a)})
    return out


def bench_spmm(n_grid: int, kind: str, dtype=jnp.float32, ncols=(1, 4, 8)):
    """SpMM on the Maxwell operator (kind = stencil | stacked | ell) or on
    a 2-D Laplacian of the same row count (kind = dia)."""
    from lanczos_tpu.models.laplacian import laplacian_2d_scipy
    from lanczos_tpu.models.maxwell import MaxwellOperator, maxwell_ell_operator
    from lanczos_tpu.models.maxwell_stacked import StackedMaxwellOperator
    from lanczos_tpu.ops.formats import dia_from_scipy

    if kind == "stencil":
        op = MaxwellOperator.create(n_grid, n_grid, n_grid, dtype=dtype)
        state = (op.n,)
    elif kind == "stacked":
        op = StackedMaxwellOperator.create(n_grid, n_grid, n_grid, dtype=dtype)
        state = op.state_shape
    elif kind == "ell":
        op = maxwell_ell_operator(n_grid, n_grid, n_grid)
        state = (op.shape[0],)
    else:
        side = int(round((4 * n_grid**3) ** 0.5))
        op = dia_from_scipy(laplacian_2d_scipy(side, side), dtype=dtype)
        state = (op.shape[0],)
    planes = sum(x.nbytes for x in jax.tree.leaves(op))
    out = []
    for p in ncols:
        x = jax.random.normal(jax.random.PRNGKey(0), (p,) + state, dtype)
        s = steady(jax.jit(lambda op, x: op.mm(x)), op, x)
        out.append(_row(p, s, 2 * x.nbytes + planes, rows=op.shape[0],
                        nnz_per_s=4 * op.shape[0] * p / s))
    return out


def bench_fused_iter(n_grid: int, dtype=jnp.float32, ncols=(1, 2, 4, 8)):
    """Seconds per block-Lanczos iteration on the Maxwell stencil, fused
    recurrence (3 state passes) against the materialized one."""
    from lanczos_tpu.methods.block_lanczos import block_lanczos
    from lanczos_tpu.models.maxwell import MaxwellOperator

    op = MaxwellOperator.create(n_grid, n_grid, n_grid, dtype=dtype)
    out = []
    for p in ncols:
        b = jax.random.normal(jax.random.PRNGKey(0), (p, op.n), dtype)
        row = {"n_col": p, "state_bytes": b.nbytes}
        for fused in (True, False):
            g = jax.jit(lambda op, b, m, fused=fused: block_lanczos(
                op, b, m, fused=fused).alphas, static_argnums=2)
            row["fused" if fused else "materialized"] = per_iteration(
                lambda m: g(op, b, m), 4, 12)
        out.append(row)
    return out


def run(args) -> dict:
    sections = {
        "copy": lambda: bench_copy(args.rows),
        "gram": lambda: bench_gram(args.rows),
        "mix": lambda: bench_mix(args.rows),
        "sqrtm": lambda: bench_sqrtm(),
        "sqrtm_newton": lambda: bench_sqrtm(backend="newton"),
        "spmm_stencil": lambda: bench_spmm(args.grid, "stencil"),
        "spmm_stacked": lambda: bench_spmm(args.grid, "stacked"),
        "spmm_ell": lambda: bench_spmm(args.grid, "ell"),
        "spmm_dia": lambda: bench_spmm(args.grid, "dia"),
        "fused_iter": lambda: bench_fused_iter(args.grid),
    }
    only = args.only.split(",") if args.only else list(sections)
    results = {}
    for name in only:
        results[name] = sections[name]()
        print(name, json.dumps(results[name]), flush=True)
    return results


def main():
    from lanczos_tpu.utils.compile_cache import use_checkout_cache
    from lanczos_tpu.utils.timing import card_line, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=24_806_880)  # N=160 state
    ap.add_argument("--grid", type=int, default=160)
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated section names")
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args()
    dev = require_gpu("kernel_bench")
    use_checkout_cache()
    card = card_line()
    print(f"card: {card}", flush=True)
    results = run(args)
    results["device"] = {"kind": dev.device_kind, "card": card}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
