"""Smoke run of the two main paths on the GPU, at the reference's full size.

    python chip_smoke.py              # phases A, B, C on one card
    python chip_smoke.py --devices 4  # only the multi-card paths (phase D)

Phase A  the reference's Maxwell expm fixture (N=160, 24.6M rows) through
         `cli.run`, block p=4 and vector, against the FDTD oracle on the
         card; per-iteration time of the fused and materialized
         recurrences; stencil `mm` of both state layouts against a copy.
Phase B  `block_lanczos_eigsh` (p=8, periodic reorth, k=5) on the seeded
         10,485,760-row banded matrix through gathered ELL and through
         `io.auto_operator` (DIA), with measured Ritz residuals.
Phase C  the Gram products: the Triton-route kernel and XLA's einsum
         against a float64 jnp reference at precision HIGHEST, timed alone
         and inside the fused iteration; the XLA block mix against a copy.
Phase D  (--devices 4) the row-sharded ELL eigsh at 4x the rows and the
         z-sharded Maxwell block expm, each against one card in the same
         process, with the rematerialization and per-card memory guards.

Every phase prints one JSON line per measurement.  The card's name and
power limit come from nvidia-smi; the last line is the device record.  The
script refuses to run without a GPU and catches no phase's failure.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from lanczos_tpu.utils.compile_cache import use_checkout_cache
from lanczos_tpu.utils.timing import card_line, per_iteration, require_gpu, steady

ROOT = os.path.dirname(os.path.abspath(__file__))

# relative_error bound of phase A.  In float64 on the CPU at N=10 the same
# check (m=10, t_end=0.02, dt=1e-6) reads 1.1e-12 (block) and 6.2e-13
# (vector): Lanczos truncation and the Euler oracle's own error are
# negligible here, so what the card shows is float32 rounding.  On the CPU
# in float32 the block path reads 1.8e-5..4.3e-5 at N=10..24 (the sqrtm
# normalization of the strongly overlapping Gaussian start block) and the
# vector path <= 3e-7; the bounds leave room for that rounding to grow
# with N.
TOL_EXPM = {"block": 1e-3, "vector": 1e-4}
# phase B: measured relative residual ||Ay - theta y|| / |theta| bound, and
# ELL-vs-DIA Ritz agreement (the same f32 recurrence over two operators
# whose products differ only in summation order).
TOL_RESID = 1e-3
TOL_RITZ = 1e-4
# phase C: Gram blocks vs the f64 reference, relative to max |G| (f32
# accumulation over n products in two different orders).
TOL_GRAM = 1e-4
# phase D: four cards against one.
TOL_DIST = 1e-3


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}, default=float), flush=True)


def compiled(fn, *args):
    """(compiled fn, compile seconds) for jax.jit(fn) at these args."""
    t0 = time.perf_counter()
    c = jax.jit(fn).lower(*args).compile()
    return c, time.perf_counter() - t0


def peak_bytes(dev=None) -> int | None:
    stats = (dev or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _copy(x):
    return x + 1.0


# ---------------------------------------------------------------------------
# Phase A: Maxwell expm
# ---------------------------------------------------------------------------


def phase_a(n_grid=160, m=10, t_end=0.02, fdtd_steps=20_000,
            timing_grids=(160, 24)) -> None:
    from lanczos_tpu.cli import run
    from lanczos_tpu.config import LanczosConfig
    from lanczos_tpu.methods.block_lanczos import block_lanczos
    from lanczos_tpu.methods.expm_action import (
        block_lanczos_expm_action,
        lanczos_expm_action,
    )
    from lanczos_tpu.methods.vector_lanczos import vector_lanczos
    from lanczos_tpu.models.maxwell import MaxwellOperator
    from lanczos_tpu.models.maxwell_stacked import StackedMaxwellOperator
    from lanczos_tpu.models.rhs import gaussian_matrix_B, gaussian_vector_b

    for mode in ("block", "vector"):
        cfg = LanczosConfig(n_grid=n_grid, m=m, block=mode == "block",
                            n_col=4, t_end=t_end, fdtd_steps=fdtd_steps)
        out = run(cfg)
        op = MaxwellOperator.create(n_grid, n_grid, n_grid)
        if mode == "block":
            b = jnp.asarray(gaussian_matrix_B(n_grid, op.n, 4), jnp.float32)
            f = lambda op, b: block_lanczos_expm_action(
                op, b, m, t_end, out["lc"])
        else:
            b = jnp.asarray(gaussian_vector_b(n_grid, op.n), jnp.float32)
            f = lambda op, b: lanczos_expm_action(op, b, m, t_end, out["lc"])
        fc, compile_s = compiled(f, op, b)
        sol = np.asarray(fc(op, b))
        rel = float(out["relative_error"])
        emit("A", run=f"expm_{mode}", n=op.n, m=m, t_end=t_end,
             fdtd_steps=fdtd_steps, lc=out["lc"], compile_s=compile_s,
             steady_s=steady(fc, op, b),
             first_call_s=out["lanczos_seconds"],
             fdtd_s=out["fdtd_seconds"], relative_error=rel,
             tolerance=TOL_EXPM[mode], finite=bool(np.isfinite(sol).all()),
             peak_bytes_in_use=peak_bytes())
        assert np.isfinite(sol).all() and rel <= TOL_EXPM[mode], (mode, rel)
        del b

    key = jax.random.PRNGKey(1)
    for ng in timing_grids:
        op = MaxwellOperator.create(ng, ng, ng)
        for p in (1, 4):
            x = jax.random.normal(key, (p, op.n), jnp.float32)
            row = {}
            for fused in (True, False):
                if p == 1:
                    g = jax.jit(lambda op, x, m, fused=fused: vector_lanczos(
                        op, x[0], m, fused=fused).alphas,
                        static_argnums=2)
                else:
                    g = jax.jit(lambda op, x, m, fused=fused: block_lanczos(
                        op, x, m, fused=fused).alphas,
                        static_argnums=2)
                row["fused" if fused else "materialized"] = per_iteration(
                    lambda m: g(op, x, m), 6, 18)
            emit("A", run="iteration", n_grid=ng, n=op.n, p=p,
                 state_bytes=x.nbytes, fused_s_per_iter=row["fused"],
                 materialized_s_per_iter=row["materialized"])
            del x

    # stencil mm of both state layouts against a copy of the same state
    p = 4
    flat = MaxwellOperator.create(n_grid, n_grid, n_grid)
    stk = StackedMaxwellOperator.create(n_grid, n_grid, n_grid)
    for name, op, x in (
        ("flat", flat, jax.random.normal(key, (p, flat.n), jnp.float32)),
        ("stacked", stk,
         jax.random.normal(key, (p,) + stk.state_shape, jnp.float32)),
    ):
        mm = jax.jit(lambda op, x: op.mm(x))
        t_mm = steady(mm, op, x)
        t_copy = steady(jax.jit(_copy), x)
        emit("A", run="stencil_mm", layout=name, p=p, state_bytes=x.nbytes,
             mm_s=t_mm, copy_s=t_copy,
             floor_gbps_2S=2 * x.nbytes / t_mm / 1e9,
             copy_gbps=2 * x.nbytes / t_copy / 1e9)
        del x


# ---------------------------------------------------------------------------
# Phase B: assembled matrix at SuiteSparse scale
# ---------------------------------------------------------------------------


def _eigsh_run(op, b, m, k):
    from lanczos_tpu.methods.eigs import block_lanczos_eigsh, ritz_residuals

    def f(op, b):
        vals, vecs, bound = block_lanczos_eigsh(
            op, b, m, k, reorth="periodic", compute_vectors=True)
        return vals, bound, ritz_residuals(op, vals, vecs)

    return f


def phase_b(n_rows=10_485_760, p=8, m=8, k=5, seed=0) -> None:
    from lanczos_tpu.io import auto_operator
    from lanczos_tpu.models.banded import synth_suitesparse_banded
    from lanczos_tpu.ops.formats import ell_from_scipy

    t0 = time.perf_counter()
    a = synth_suitesparse_banded(n_rows, seed=seed)
    build_s = time.perf_counter() - t0
    b = jax.random.normal(jax.random.PRNGKey(seed), (p, n_rows), jnp.float32)
    ritz = {}
    for name, make in (("ell", ell_from_scipy), ("auto", auto_operator)):
        t0 = time.perf_counter()
        op = make(a)
        jax.block_until_ready(op)
        pack_s = time.perf_counter() - t0
        f = _eigsh_run(op, b, m, k)
        fc, compile_s = compiled(f, op, b)
        vals, bound, resid = (np.asarray(v) for v in fc(op, b))
        t_mm = steady(jax.jit(lambda op, x: op.mm(x)), op, b)
        emit("B", run=f"eigsh_{name}", operator=type(op).__name__,
             n=n_rows, nnz=int(a.nnz), p=p, m=m, k=k, reorth="periodic",
             assemble_s=build_s, pack_s=pack_s, compile_s=compile_s,
             steady_s=steady(fc, op, b), ritz=vals.tolist(),
             bound=bound.tolist(), measured_resid=resid.tolist(),
             tolerance=TOL_RESID, mm_s=t_mm,
             mm_nnz_per_s=a.nnz * p / t_mm,
             mm_min_gbps=_spmm_bytes(op, p) / t_mm / 1e9,
             peak_bytes_in_use=peak_bytes())
        assert np.isfinite(vals).all() and (resid <= TOL_RESID).all(), resid
        assert name == "ell" or type(op).__name__ == "DiaMatrix"
        ritz[name] = vals
        del op
    d = np.abs(ritz["ell"] - ritz["auto"]) / np.abs(ritz["ell"])
    emit("B", run="ell_vs_dia", max_rel_diff=float(d.max()),
         tolerance=TOL_RITZ)
    assert d.max() <= TOL_RITZ, d


def _spmm_bytes(op, p) -> int:
    """Least bytes of one block SpMM: the stored planes once, the block
    read once and written once."""
    planes = sum(x.nbytes for x in jax.tree.leaves(op))
    return planes + 2 * p * op.shape[0] * 4


# ---------------------------------------------------------------------------
# Phase C: Gram kernel against XLA
# ---------------------------------------------------------------------------


def phase_c(n_grid=160, ps=(1, 4, 8), m_iter=(6, 18),
            interpret=False) -> None:
    import lanczos_tpu.methods.block_lanczos_fused as blf
    from lanczos_tpu.methods.block_lanczos import block_lanczos
    from lanczos_tpu.models.maxwell import MaxwellOperator
    from lanczos_tpu.ops.block_dense import block_mix, gram_reference
    from lanczos_tpu.ops.pallas.gram import triton_grams

    op = MaxwellOperator.create(n_grid, n_grid, n_grid)
    key = jax.random.PRNGKey(2)
    # the fused iteration with each Gram implementation in place
    b = jax.random.normal(key, (4, op.n), jnp.float32)
    per = {}
    for name, impl in (
        ("triton", None),
        ("xla", lambda xs, z, include_zz=False, acc_dtype=None:
            gram_reference(xs, z, include_zz, acc_dtype)),
    ):
        orig = blf.block_grams
        if impl is not None:
            blf.block_grams = impl
        jax.clear_caches()
        try:
            g = jax.jit(lambda op, b, m: block_lanczos(
                op, b, m, fused=True).alphas, static_argnums=2)
            per[name] = per_iteration(lambda m: g(op, b, m), *m_iter)
        finally:
            blf.block_grams = orig
    jax.clear_caches()
    emit("C", run="fused_iteration", n_grid=n_grid, p=4,
         triton_s_per_iter=per["triton"], xla_s_per_iter=per["xla"])
    del b

    jax.config.update("jax_enable_x64", True)  # the f64 reference
    for p in ps:
        kq, kv = jax.random.split(jax.random.fold_in(key, p))
        q = jax.random.normal(kq, (p, op.n), jnp.float32)
        v = jax.random.normal(kv, (p, op.n), jnp.float32)
        ref = np.asarray(gram_reference((q,), v, True, jnp.float64))
        scale = np.abs(ref).max()
        xla, _ = compiled(lambda q, v: gram_reference((q,), v, True), q, v)
        tri, compile_s = compiled(lambda q, v: triton_grams(
            (q,), v, include_zz=True, interpret=interpret), q, v)
        err = {k: float(np.abs(np.asarray(f(q, v)) - ref).max() / scale)
               for k, f in (("xla", xla), ("triton", tri))}
        t = {k: steady(f, q, v) for k, f in (("xla", xla), ("triton", tri))}
        nbytes = q.nbytes + v.nbytes
        emit("C", run="gram", p=p, n=op.n, bytes=nbytes,
             triton_compile_s=compile_s, peak_bytes_in_use=peak_bytes(),
             xla_s=t["xla"], triton_s=t["triton"],
             xla_gbps=nbytes / t["xla"] / 1e9,
             triton_gbps=nbytes / t["triton"] / 1e9,
             xla_err=err["xla"], triton_err=err["triton"],
             tolerance=TOL_GRAM, precision="HIGHEST, f64 reference")
        assert max(err.values()) <= TOL_GRAM, err
        if p == 4:
            tri64 = jax.jit(lambda q, v: triton_grams(
                (q,), v, include_zz=True, acc_dtype=jnp.float64,
                interpret=interpret))
            e64 = float(np.abs(np.asarray(tri64(q, v)) - ref).max() / scale)
            emit("C", run="gram_f64_acc", p=p, triton_s=steady(tri64, q, v),
                 triton_err=e64)
            w = jax.random.normal(key, (p, op.n), jnp.float32)
            e = jax.random.normal(key, (3 * p, p), jnp.float32)
            mix = jax.jit(lambda e, q, v, w: block_mix(e, (q, v, w)))
            t_mix = steady(mix, e, q, v, w)
            got = np.asarray(mix(e, q, v, w))
            want = np.einsum("kj,kn->jn", np.asarray(e, np.float64),
                             np.concatenate([np.asarray(x, np.float64)
                                             for x in (q, v, w)]))
            emit("C", run="block_mix", p=p, k=3 * p, mix_s=t_mix,
                 copy_s=steady(jax.jit(_copy), q),
                 mix_gbps=4 * q.nbytes / t_mix / 1e9,
                 err=float(np.abs(got - want).max() / np.abs(want).max()))
            del w
        del q, v

# ---------------------------------------------------------------------------
# Phase D: four cards
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def stderr_captured(sink: list):
    """Capture fd 2 (XLA's C++ warnings) into sink[0]; re-emit on exit."""
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as tmp:
        os.dup2(tmp.fileno(), 2)
        try:
            yield
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            tmp.seek(0)
            sink.append(tmp.read().decode(errors="replace"))
            sys.stderr.write(sink[-1])
            sys.stderr.flush()


def phase_d(n_devices=4, n_rows=4 * 10_485_760, n_grid=160, p=8, m=8, k=5,
            expm_m=10, t_end=0.02, seed=0) -> None:
    from lanczos_tpu.cli import run
    from lanczos_tpu.config import LanczosConfig
    from lanczos_tpu.models.banded import synth_suitesparse_banded
    from lanczos_tpu.ops.formats import ell_from_scipy
    from lanczos_tpu.parallel import halo_sharded_ell, make_mesh

    mesh = make_mesh(n_devices)
    a = synth_suitesparse_banded(n_rows, seed=seed)
    # made on the host: a start block made on device 0 would sit in its peak
    b_np = np.random.default_rng(seed).standard_normal(
        (p, n_rows), dtype=np.float32)
    log = []
    with stderr_captured(log):
        # sharded runs first: the per-card peaks below then cover them only
        dop = halo_sharded_ell(a, mesh)
        db = dop.pad_vector(b_np)
        f = _eigsh_run(dop, db, m, k)
        fc, compile_s = compiled(f, dop, db)
        vals_d, bound_d, resid_d = (np.asarray(x) for x in fc(dop, db))
        t_d = steady(fc, dop, db)
        del dop, db
        cfg = dict(n_grid=n_grid, m=expm_m, block=True, n_col=4,
                   t_end=t_end, validate=False, operator="stacked")
        out_d = run(LanczosConfig(devices=n_devices, **cfg))
    peaks = [peak_bytes(d) for d in mesh.devices.ravel()]
    emit("D", run="guards", remat_warning=any(
        "Involuntary full rematerialization" in s for s in log),
        peak_bytes_in_use=peaks)
    assert not any("Involuntary full rematerialization" in s for s in log)
    if jax.default_backend() == "gpu":  # the CPU backend keeps no stats
        assert None not in peaks and max(peaks) <= 1.5 * min(peaks), peaks

    op = ell_from_scipy(a)
    b = jnp.asarray(b_np)
    f = _eigsh_run(op, b, m, k)
    vals_s, _, resid_s = (np.asarray(x) for x in jax.jit(f)(op, b))
    d = float((np.abs(vals_d - vals_s) / np.abs(vals_s)).max())
    emit("D", run="eigsh_halo_ell", devices=n_devices, n=n_rows,
         nnz=int(a.nnz), p=p, m=m, k=k, compile_s=compile_s, steady_s=t_d,
         ritz=vals_d.tolist(), measured_resid=resid_d.tolist(),
         single_card_resid=resid_s.tolist(), max_rel_diff=d,
         tolerance=TOL_DIST)
    assert (resid_d <= TOL_RESID).all() and d <= TOL_DIST
    del op, b

    out_s = run(LanczosConfig(devices=1, **cfg))
    sd, ss = np.asarray(out_d["solution"]), np.asarray(out_s["solution"])
    d = float(np.linalg.norm(sd - ss) / np.linalg.norm(ss))
    emit("D", run="expm_stacked", devices=n_devices, n_grid=n_grid,
         m=expm_m, seconds_4=out_d["lanczos_seconds"],
         seconds_1=out_s["lanczos_seconds"], rel_diff=d, tolerance=TOL_DIST)
    assert np.isfinite(sd).all() and d <= TOL_DIST


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4])
    args = ap.parse_args(argv)
    require_gpu("chip_smoke")
    if len(jax.devices()) < args.devices:
        sys.exit(f"chip_smoke: {args.devices} GPUs needed, "
                 f"{len(jax.devices())} found")
    cache = use_checkout_cache(ROOT)
    print(f"card: {card_line()}", flush=True)
    print(f"compile cache: {cache}", flush=True)
    if args.devices == 4:
        phase_d()
    else:
        phase_a()
        phase_b()
        phase_c()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
