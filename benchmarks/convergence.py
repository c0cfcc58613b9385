"""Convergence-vs-m curve on the reference's oracle configuration.

Reproduces the reference's published convergence experiment
(`lanczos_plots.m:166-185`, BASELINE.md): problem size n=252 (N=3 grid),
Lanczos-expm receiver value vs a 10^6-step forward-Euler FDTD run, for
m = 1..12.  The reference curve falls from 5.5e-2 at m=1 to a ~1.8e-9
plateau at m >= 6 (float64 path).

An accuracy experiment, not a timing: it runs on the CPU (n=252 is
tiny) in float64 and writes a CSV of (m, relative error).

Usage: python benchmarks/convergence.py [--block] [--csv out.csv]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", action="store_true")
    ap.add_argument("--n-grid", type=int, default=3)
    ap.add_argument("--m-max", type=int, default=12)
    ap.add_argument("--fdtd-steps", type=int, default=1_000_000)
    # lc=30 reproduces the reference's published plateau (~1.8e-9 by m=6,
    # lanczos_plots.m:168); distant receivers (e.g. lc ~ 77) sit at the
    # FDTD oracle's own forward-Euler error floor instead.
    ap.add_argument("--lc", type=int, default=30)
    ap.add_argument("--csv", default="convergence.csv")
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from lanczos_tpu.methods.expm_action import (
        block_lanczos_expm_action,
        lanczos_expm_action,
    )
    from lanczos_tpu.methods.fdtd import fdtd_block, fdtd_vector
    from lanczos_tpu.models.maxwell import MaxwellOperator
    from lanczos_tpu.models.rhs import gaussian_matrix_B, gaussian_vector_b

    N = args.n_grid
    op = MaxwellOperator.create(N, N, N, dtype=jnp.float64)
    n, lc = op.n, args.lc

    if args.block:
        b = jnp.asarray(np.asarray(gaussian_matrix_B(N, n, 4), np.float64))
        ref = np.asarray(fdtd_block(op, b, args.fdtd_steps, 1.0))[:, lc]
    else:
        b = jnp.asarray(np.asarray(gaussian_vector_b(N, n), np.float64))
        ref = float(fdtd_vector(op, b, args.fdtd_steps, 1.0)[lc])

    rows = []
    for m in range(1, args.m_max + 1):
        if args.block:
            sol = np.asarray(block_lanczos_expm_action(op, b, m, 1.0, lc))
            rel = float(np.linalg.norm(sol - ref) / np.linalg.norm(ref))
        else:
            sol = float(lanczos_expm_action(op, b, m, 1.0, lc))
            rel = abs(sol - ref) / abs(ref)
        rows.append({"m": m, "rel_error": rel})
        print(f"m={m:2d}  rel_error={rel:.3e}", flush=True)

    with open(args.csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["m", "rel_error"])
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
