"""BASELINE configs 3-5 on one GPU: an assembled >=10M-row, >=100M-nnz
SuiteSparse-style banded SPD matrix (`models/banded.py`) through the
assembled-matrix operators and block-Lanczos eigsh, end to end.

Reference counterpart: `measurements/spmv_spmm.cu:345` benchmarks the
gathered ELL SpMM at N=160 (24.6M rows); the whole-algorithm driver is
`tensor_core_unfinished_work/measure_lanczos.cu`.  This script records:

  * block SpMM nnz/s of the gathered ELL, DIA and BSR (bs=8) operators,
    with the least bytes each needs against a copy of the same state,
  * top-k Ritz values with the |beta_m S| bounds and the
    ITERATIONS-TO-CONVERGE curve (bound vs block steps, recovered from
    truncations of the block-tridiagonal T),
  * MEASURED relative residuals ||A y - theta y|| / |theta|,
  * a .mtx round-trip on a small slab (io.py loaders).

Times are the host clock around `block_until_ready`.  Refuses to run
without a GPU.

Usage: python benchmarks/suitesparse_scale.py [--rows 10485760] [--json out]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lanczos_tpu.models.banded import synth_suitesparse_banded  # noqa: E402


def convergence_curve(alphas, betas, beta_final, k, cluster_rtol=1e-4):
    """Residual bound of the top-k DISTINCT Ritz values for every
    truncation m' <= m, from the block-tridiagonal coefficients alone.

    With reorth='periodic' the basis stays orthogonal and the clustering
    is a no-op; it is kept so --reorth none runs (where converged
    eigenvalues spawn GHOST duplicates — loss of orthogonality, Paige's
    analysis) still report distinct values: cluster within `cluster_rtol`
    and keep each cluster's best-resid member."""
    from lanczos_tpu.ops.tridiag import assemble_block_tridiagonal

    m, p, _ = np.asarray(alphas).shape
    curve = []
    for mp in range(1, m + 1):
        t = np.asarray(
            assemble_block_tridiagonal(
                jnp.asarray(alphas[:mp]), jnp.asarray(betas[1:mp])
            )
        )
        w, s = np.linalg.eigh(t)
        bf = np.asarray(betas[mp]) if mp < m else np.asarray(beta_final)
        resid_all = np.linalg.norm(bf @ s[-p:, :], axis=0)
        order = np.argsort(w)[::-1]
        scale = abs(w[order[0]]) if len(order) else 1.0
        ritz, resid = [], []
        for i in order:
            if any(abs(w[i] - r) <= cluster_rtol * max(scale, 1.0)
                   for r in ritz):
                # ghost duplicate: keep the better residual for the cluster
                j = int(np.argmin([abs(w[i] - r) for r in ritz]))
                resid[j] = min(resid[j], float(resid_all[i]))
                continue
            ritz.append(float(w[i]))
            resid.append(float(resid_all[i]))
            if len(ritz) == k:
                break
        curve.append({"m": mp, "ritz": ritz, "resid": resid})
    return curve


def run(rows: int, p: int, m: int, k: int, reorth: str, tol: float) -> dict:
    from lanczos_tpu.io import load_sparse
    from lanczos_tpu.methods.eigs import block_lanczos_eigsh, ritz_residuals
    from lanczos_tpu.methods.block_lanczos import block_lanczos
    from lanczos_tpu.ops.formats import (
        bsr_from_scipy,
        dia_from_scipy,
        ell_from_scipy,
    )
    from lanczos_tpu.utils.timing import steady
    from scipy.io import mmwrite

    out = {"rows": rows, "p": p, "m": m, "k": k, "reorth": reorth}
    t0 = time.perf_counter()
    a = synth_suitesparse_banded(rows)
    out["nnz"] = int(a.nnz)
    out["assemble_seconds"] = time.perf_counter() - t0

    slab = a[:2000, :2000].tocoo()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "slab.mtx")
        mmwrite(path, slab)
        err = abs(slab.tocsr() - load_sparse(path)).max()
        assert err <= 1e-6 * abs(slab).max()
    out["mtx_roundtrip"] = True

    x = jax.random.normal(jax.random.PRNGKey(0), (p, rows), jnp.float32)
    out["copy_seconds"] = steady(jax.jit(lambda x: x + 1), x)
    ops = {"ell": ell_from_scipy(a), "dia": dia_from_scipy(a),
           "bsr8": bsr_from_scipy(a, block_size=8)}
    for name, op in ops.items():
        sec = steady(jax.jit(lambda op, x: op.mm(x)), op, x)
        planes = sum(v.nbytes for v in jax.tree.leaves(op))
        out[f"spmm_{name}_seconds"] = sec
        out[f"spmm_{name}_nnz_per_s"] = a.nnz * p / sec
        out[f"spmm_{name}_min_gbps"] = (planes + 2 * x.nbytes) / sec / 1e9
        print(f"spmm {name}: {sec * 1e3:.3f} ms "
              f"{out[f'spmm_{name}_nnz_per_s']:.3e} nnz/s", flush=True)

    op = ops["ell"]
    t0 = time.perf_counter()
    res = jax.block_until_ready(block_lanczos(op, x, m, reorth=reorth))
    out["lanczos_seconds"] = time.perf_counter() - t0
    curve = convergence_curve(np.asarray(res.alphas), np.asarray(res.betas),
                              np.asarray(res.beta_final), k)
    out["convergence"] = curve
    scale = max(abs(v) for v in curve[-1]["ritz"])
    out["iters_to_converge"] = next(
        (c["m"] for c in curve if max(c["resid"]) < tol * scale), None)
    vals, vecs, bound = block_lanczos_eigsh(op, x, m, k, reorth=reorth,
                                            compute_vectors=True)
    out["top_ritz"] = np.asarray(vals).tolist()
    out["resid_bound"] = np.asarray(bound).tolist()
    out["measured_resid"] = np.asarray(ritz_residuals(op, vals, vecs)).tolist()
    print(f"top-{k} Ritz {out['top_ritz']} measured_resid "
          f"{out['measured_resid']} iters_to_{tol}: "
          f"{out['iters_to_converge']}", flush=True)
    return out


def main():
    from lanczos_tpu.utils.compile_cache import use_checkout_cache
    from lanczos_tpu.utils.timing import card_line, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_485_760)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--m", type=int, default=12)
    ap.add_argument("--reorth", default="periodic")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args()
    dev = require_gpu("suitesparse_scale")
    use_checkout_cache()
    card = card_line()
    print(f"card: {card}", flush=True)
    out = run(args.rows, args.p, args.m, args.k, args.reorth, args.tol)
    out["device"] = {"kind": dev.device_kind, "card": card}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}", flush=True)


if __name__ == "__main__":
    main()
