"""Whole-algorithm sweep driver — the analogue of the reference's
`tensor_core_unfinished_work/measure_lanczos.cu` (SURVEY.md §2 #24), on
the GPU.

Sweeps the Maxwell problem size N (geometric, like the reference's
`measure_lanczos.cu:329-334`) or, with --sweep-ncol, the block width
N_COL = 2..18 at a fixed N.  Each row times the FULL (block-)Lanczos run
at two iteration counts m1 < m2 and reports the per-iteration time as the
slope (t(m2) - t(m1)) / (m2 - m1), host clock around `block_until_ready`.
Each row also carries the reference's analytic per-iteration byte/flop
model (`measure_lanczos.cu:268-300`) evaluated for our sizes, so GB/s and
GFLOPS columns are comparable with BASELINE.md's tables, and the
block-width sweep the reference's per-vector speedup
`(1/((t/N_COL)/t_vl) - 1)*100 %` (`lanczos_plots.m:141-150`).

Writes CSV (the analogue of the reference's `file_VL.csv`/`file_BL.csv`).

Usage:
    python benchmarks/sweep_lanczos.py --block --n-col 4 --csv file_BL.csv
    python benchmarks/sweep_lanczos.py --vector --csv file_VL.csv
    python benchmarks/sweep_lanczos.py --sweep-ncol --n 160
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def iteration_model(n: int, p: int, width: int = 4, itemsize: int = 4):
    """Analytic per-iteration byte/flop counts of one block-Lanczos
    iteration, following the reference's accounting
    (`measure_lanczos.cu:268-300`): spmm (ELL data+idx+vectors), the two
    Gram products, the two tall x small updates, and the basis copy.
    For p == 1 this reduces to the vector-Lanczos model (:101-127)."""
    nv = n * itemsize  # one n-vector
    spmm_bytes = n * width * (itemsize + 4) + 2 * p * nv
    gram_bytes = 2 * (2 * p * nv)  # mm_tt + mm_tt2 (T read twice, ref model)
    ts_bytes = 3 * (3 * p * nv)  # Q1=W*inv, W-=Q0 b, W-=Q1 a (r,r,w)
    flops = 2.0 * n * width * p + 12.0 * n * p * p
    return spmm_bytes + gram_bytes + ts_bytes, flops


def time_row(n_grid: int, p: int, m1: int, m2: int, reorth: str = "none",
             operator: str = "stencil") -> dict:
    """Per-iteration seconds of the Lanczos run on the N=n_grid Maxwell
    operator at block width p (p=1: vector Lanczos)."""
    from lanczos_tpu.methods.block_lanczos import block_lanczos
    from lanczos_tpu.methods.vector_lanczos import vector_lanczos
    from lanczos_tpu.models.maxwell import MaxwellOperator
    from lanczos_tpu.models.maxwell_stacked import StackedMaxwellOperator
    from lanczos_tpu.models.rhs import gaussian_matrix_B, gaussian_vector_b
    from lanczos_tpu.utils.timing import per_iteration

    if operator == "stacked":
        op = StackedMaxwellOperator.create(n_grid, n_grid, n_grid)
        pack, trace_fn = op.pack, op.trace_fn(0)
    else:
        op = MaxwellOperator.create(n_grid, n_grid, n_grid)
        pack, trace_fn = jnp.asarray, None
    n = op.n
    if p == 1:
        b = pack(np.asarray(gaussian_vector_b(n_grid, n), np.float32))
        vtrace = None if trace_fn is None else trace_fn
        run = lambda m: vector_lanczos(op, b, m, reorth=reorth,
                                       trace_fn=vtrace).alphas
    else:
        b = pack(np.asarray(gaussian_matrix_B(n_grid, n, p), np.float32))
        run = lambda m: block_lanczos(op, b, m, reorth=reorth,
                                      trace_fn=trace_fn).alphas
    sec = per_iteration(run, m1, m2)
    bts, fl = iteration_model(n, p)
    return {"n": n, "n_grid": n_grid, "p": p, "m1": m1, "m2": m2,
            "seconds_per_iter": sec, "gbps_model": bts / sec / 1e9,
            "gflops_model": fl / sec / 1e9}


def sweep(args):
    if args.sweep_ncol:
        t_vl = time_row(args.n, 1, args.m1, args.m2, args.reorth,
                        args.operator)["seconds_per_iter"]
        jobs = [(args.n, p) for p in (2, 4, 6, 8, 10, 12, 14, 16, 18)]
    else:
        sizes, x = [], float(args.n_min)
        while round(x) <= args.n_max:
            if not sizes or round(x) != sizes[-1]:
                sizes.append(int(round(x)))
            x *= args.factor
        p = args.n_col if args.block else 1
        jobs = [(n_grid, p) for n_grid in sizes]
        t_vl = None
    rows = []
    for n_grid, p in jobs:
        row = time_row(n_grid, p, args.m1, args.m2, args.reorth,
                       args.operator)
        if t_vl is not None:
            row["per_vector_speedup_pct"] = (
                1.0 / ((row["seconds_per_iter"] / p) / t_vl) - 1.0) * 100.0
        rows.append(row)
        print("  ".join(f"{k}={v:.4g}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in row.items()), flush=True)
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[-1]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    return rows


def parser():
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--block", action="store_true", default=True)
    g.add_argument("--vector", dest="block", action="store_false")
    ap.add_argument("--n-col", type=int, default=4)
    ap.add_argument("--n-min", type=int, default=10)
    ap.add_argument("--n-max", type=int, default=200)
    ap.add_argument("--factor", type=float, default=1.25)
    ap.add_argument("--n", type=int, default=160,
                    help="grid size of --sweep-ncol")
    ap.add_argument("--m1", type=int, default=4)
    ap.add_argument("--m2", type=int, default=16)
    ap.add_argument("--reorth", default="none")
    ap.add_argument("--operator", default="stencil",
                    choices=["stencil", "stacked"])
    ap.add_argument("--csv", type=str, default=None)
    ap.add_argument("--sweep-ncol", action="store_true",
                    help="fixed problem size, sweep block width N_COL "
                         "2..18 + the single-vector run, reporting the "
                         "reference's per-vector speedup")
    return ap


def main():
    from lanczos_tpu.utils.compile_cache import use_checkout_cache
    from lanczos_tpu.utils.timing import card_line, require_gpu

    args = parser().parse_args()
    require_gpu("sweep_lanczos")
    use_checkout_cache()
    print(f"card: {card_line()}", flush=True)
    sweep(args)


if __name__ == "__main__":
    main()
