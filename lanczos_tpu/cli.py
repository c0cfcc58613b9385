"""CLI driver — the reference's `test_lanczos.cu` main.

    python -m lanczos_tpu -N 10 -m 5 --block --n-col 4
    python -m lanczos_tpu -N 10 -m 8 --vector --reorth selective
    python -m lanczos_tpu -N 8 -m 5 --operator stacked --devices 4

Assembles the 3-D Maxwell fixture, runs (block) Lanczos, propagates the
matrix exponential to the receiver index, and validates against the
forward-Euler FDTD oracle (reference `test_lanczos.cu:21-305`) — with the
reference's CLI bugs fixed: `--vector/--block` actually selects the path
(vs `use_block` hard-coded true at `test_lanczos.cu:322`) and every knob
is a runtime flag rather than a macro.
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import time

from lanczos_tpu.config import LanczosConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lanczos_tpu",
        description="single/block Lanczos expm-action driver",
    )
    ap.add_argument("-N", "--n-grid", type=int, default=10)
    ap.add_argument("-m", "--iterations", type=int, default=5)
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--block", action="store_true", default=True)
    g.add_argument("--vector", dest="block", action="store_false")
    ap.add_argument("--n-col", type=int, default=4)
    ap.add_argument("--t-end", type=float, default=1.0)
    ap.add_argument("--fdtd-steps", type=int, default=1_000_000)
    ap.add_argument("--lc", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--reorth", default="none",
                    choices=["none", "full", "selective", "periodic"])
    ap.add_argument("--eig-backend", default="jacobi",
                    choices=["jacobi", "lax", "newton"])
    ap.add_argument("--normalize", default="sqrtm",
                    choices=["sqrtm", "qr"],
                    help="block normalization: reference sqrtm(W^T W) or "
                         "rank-safe TSQR")
    ap.add_argument("--breakdown-eps", type=float, default=0.0,
                    help="rank-revealing deflation threshold (relative "
                         "R-diagonal / eigenvalue cutoff)")
    ap.add_argument("--replace-dead", action="store_true",
                    help="adaptive restart: refill deflated directions "
                         "with basis-orthogonal random vectors "
                         "(needs --normalize qr, --breakdown-eps > 0, "
                         "and a basis-keeping --reorth)")
    ap.add_argument("--breakdown-tol", type=float, default=0.0,
                    help="freeze the recurrence at an (approximate) "
                    "invariant subspace: ||w||/beta_0 (vector) or the "
                    "beta-block rcond estimate (block) below this "
                    "triggers; 0 disables")
    ap.add_argument("--operator", default="stencil",
                    choices=["stencil", "stacked", "ell"],
                    help="stencil: matrix-free flat state; stacked: folded-"
                         "plane state (the one that shards over --devices); "
                         "ell: assembled gathered ELL")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    default=None,
                    help="force the materialized (reference-semantics) "
                         "recurrence instead of the traffic-minimal "
                         "fused path that bare reorth='none' runs use")
    ap.add_argument("--compensated", action="store_true",
                    help="float64 Gram accumulation on the fused path: "
                         "f64-oracle-level T coefficients from f32 storage "
                         "(the reference's all-double block driver "
                         "accuracy)")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--no-validate", dest="validate", action="store_false")
    ap.add_argument(
        "--profile", dest="profile_dir", metavar="DIR", default=None,
        help="capture a jax.profiler trace of the Lanczos run into DIR "
        "(view with TensorBoard / xprof; replaces the reference's "
        "steady_clock brackets)",
    )
    return ap


def config_from_args(args) -> LanczosConfig:
    return LanczosConfig(
        n_grid=args.n_grid, m=args.iterations, block=args.block,
        n_col=args.n_col, t_end=args.t_end, fdtd_steps=args.fdtd_steps,
        lc=args.lc, seed=args.seed, dtype=args.dtype, reorth=args.reorth,
        eig_backend=args.eig_backend,
        breakdown_tol=args.breakdown_tol, normalize=args.normalize,
        breakdown_eps=args.breakdown_eps, replace_dead=args.replace_dead,
        fused=args.fused, compensated=args.compensated,
        operator=args.operator,
        devices=args.devices, validate=args.validate,
        profile_dir=args.profile_dir,
    )


def run(cfg: LanczosConfig) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lanczos_tpu.methods.expm_action import (
        block_lanczos_expm_action,
        lanczos_expm_action,
    )
    from lanczos_tpu.methods.fdtd import fdtd_block, fdtd_vector
    from lanczos_tpu.models.maxwell import MaxwellOperator, maxwell_ell_operator
    from lanczos_tpu.models.rhs import gaussian_matrix_B, gaussian_vector_b

    dtype = jnp.dtype(cfg.dtype)
    if cfg.dtype == "float64" or cfg.compensated:
        jax.config.update("jax_enable_x64", True)
    if cfg.devices > 1 and cfg.operator != "stacked":
        raise ValueError("--devices > 1 shards the stacked operator: "
                         "pass --operator stacked")

    n_grid = cfg.n_grid
    if cfg.operator == "ell":
        op = maxwell_ell_operator(n_grid, n_grid, n_grid)
        n = op.shape[0]
        pack, unpack = jnp.asarray, lambda x: x
        trace_fn = None
    elif cfg.operator == "stacked":
        if cfg.devices > 1:
            from lanczos_tpu.parallel import DistributedStackedMaxwell, make_mesh

            mesh = make_mesh(cfg.devices)
            op = DistributedStackedMaxwell.create(
                n_grid, n_grid, n_grid, mesh, dtype=dtype
            )
        else:
            from lanczos_tpu.models.maxwell_stacked import (
                StackedMaxwellOperator,
            )

            op = StackedMaxwellOperator.create(
                n_grid, n_grid, n_grid, dtype=dtype
            )
        n = op.n
        pack, unpack = op.pack, op.unpack
        trace_fn = op.trace_fn
    else:
        op = MaxwellOperator.create(n_grid, n_grid, n_grid, dtype=dtype)
        n = op.n
        pack, unpack = jnp.asarray, lambda x: x
        trace_fn = None

    rng = random.Random(cfg.seed)
    lc = cfg.lc if cfg.lc is not None else 1 + rng.randrange(100)

    out = {"n": n, "lc": lc, "m": cfg.m, "block": cfg.block,
           "operator": cfg.operator}

    import contextlib

    profile_ctx = (
        jax.profiler.trace(cfg.profile_dir)
        if cfg.profile_dir
        else contextlib.nullcontext()
    )

    def _run_lanczos():
        if cfg.block:
            b_np = np.asarray(
                gaussian_matrix_B(n_grid, n, cfg.n_col), np.dtype(cfg.dtype)
            )
            b = pack(b_np)
            kwargs = dict(reorth=cfg.reorth, eig_backend=cfg.eig_backend,
                          breakdown_tol=cfg.breakdown_tol,
                          normalize=cfg.normalize,
                          breakdown_eps=cfg.breakdown_eps,
                          replace_dead=cfg.replace_dead,
                          fused=cfg.fused, compensated=cfg.compensated)
            if trace_fn is not None:
                sol = block_lanczos_expm_action(
                    op, b, cfg.m, cfg.t_end, 0, trace_fn=trace_fn(lc), **kwargs
                )
            else:
                sol = block_lanczos_expm_action(
                    op, b, cfg.m, cfg.t_end, lc, **kwargs
                )
            return b, np.asarray(jax.block_until_ready(sol))
        b_np = np.asarray(gaussian_vector_b(n_grid, n), np.dtype(cfg.dtype))
        b = pack(b_np)
        reorth = "none" if cfg.reorth == "periodic" else cfg.reorth
        if trace_fn is not None:
            sol = lanczos_expm_action(
                op, b, cfg.m, cfg.t_end, 0, reorth=reorth,
                breakdown_tol=cfg.breakdown_tol, trace_fn=trace_fn(lc),
                fused=cfg.fused,
            )
        else:
            sol = lanczos_expm_action(op, b, cfg.m, cfg.t_end, lc,
                                      reorth=reorth,
                                      breakdown_tol=cfg.breakdown_tol,
                                      fused=cfg.fused)
        return b, float(jax.block_until_ready(sol))

    t0 = time.perf_counter()
    with profile_ctx:  # with-block: an exception still flushes the trace
        b, sol = _run_lanczos()
    out["lanczos_seconds"] = time.perf_counter() - t0
    if cfg.profile_dir:
        out["profile_dir"] = cfg.profile_dir
    out["solution"] = np.asarray(sol).tolist()

    if cfg.validate:
        t0 = time.perf_counter()
        if cfg.block:
            u = fdtd_block(op, b, cfg.fdtd_steps, cfg.t_end)
            u = np.asarray(unpack(u))
            ref = u[:, lc]
            rel = float(
                np.linalg.norm(np.asarray(sol) - ref) / np.linalg.norm(ref)
            )
        else:
            u = fdtd_vector(op, b, cfg.fdtd_steps, cfg.t_end)
            ref = float(np.asarray(unpack(u))[lc])
            rel = abs(float(sol) - ref) / abs(ref)
        out["fdtd_seconds"] = time.perf_counter() - t0
        out["relative_error"] = rel
    return out


def main(argv=None):
    from lanczos_tpu.utils.compile_cache import use_checkout_cache

    args = build_parser().parse_args(argv)
    use_checkout_cache()
    cfg = config_from_args(args)
    out = run(cfg)
    for k, v in out.items():
        print(f"{k}: {v}")
    return out


if __name__ == "__main__":
    main()
