"""Checkpoint / resume for long Lanczos and FDTD runs.

The reference has no checkpointing (SURVEY.md §5: "Checkpoint / resume:
None") — its 10^6-step FDTD oracle and long Lanczos sweeps restart from
scratch on any failure.  Here both integrators run in restartable chunks:
the three-term recurrence's full state is tiny (two live vectors + the
coefficient history), so checkpoints are cheap and exact.

Format: a single .npz per checkpoint (atomic rename), holding the carry
vectors, coefficient/trace prefixes, and the step counter.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from lanczos_tpu.methods.vector_lanczos import VectorLanczosResult, _norm


def _atomic_savez(path: str, **arrays) -> None:
    """Write-then-rename .npz.  mkstemp gets the .npz suffix so np.savez
    writes INTO the created temp file (a suffixless temp would leave a
    stray zero-byte file behind every save)."""
    fd, tmp = tempfile.mkstemp(
        suffix=".npz", dir=os.path.dirname(path) or "."
    )
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@dataclasses.dataclass
class LanczosCheckpoint:
    """Exact state of a paused single-vector Lanczos run (reorth='none':
    the bare recurrence is memoryless beyond (q_prev, w))."""

    j: int  # completed iterations (alphas[0..j) valid)
    m: int  # target iteration count
    alphas: np.ndarray  # (m,)
    betas: np.ndarray  # (m,)
    trace: np.ndarray  # (m,)
    q_prev: np.ndarray  # (*state,)
    w: np.ndarray  # (*state,)

    def save(self, path: str) -> None:
        _atomic_savez(path, **dataclasses.asdict(self))

    @classmethod
    def load(cls, path: str) -> "LanczosCheckpoint":
        z = np.load(path)
        return cls(
            j=int(z["j"]), m=int(z["m"]), alphas=z["alphas"],
            betas=z["betas"], trace=z["trace"], q_prev=z["q_prev"], w=z["w"],
        )


def _chunk_steps(a, q_prev, w, lc_idx, trace_fn, n_steps: int):
    """n_steps bare three-term iterations starting from (q_prev, w)."""

    if trace_fn is None:
        from lanczos_tpu.ops.operator import state_trace

        def trace_at(q):
            return state_trace(q, lc_idx, block=False)
    else:
        trace_at = trace_fn

    def body(carry, _):
        q_prev, wv = carry
        beta = _norm(wv)
        q = wv / beta
        wn = a.mv(q) - beta * q_prev
        alpha = jnp.sum(wn * q)
        wn = wn - alpha * q
        return (q, wn), (alpha, beta, trace_at(q))

    (q, wn), (al, be, tr) = jax.lax.scan(
        body, (q_prev, w), None, length=n_steps
    )
    return q, wn, al, be, tr


_chunk_steps_jit = jax.jit(_chunk_steps, static_argnames=("n_steps", "trace_fn"))


def vector_lanczos_checkpointed(
    a,
    b: jax.Array,
    m: int,
    lc=None,
    *,
    chunk: int = 64,
    path: str | None = None,
    resume: bool = True,
    trace_fn=None,
) -> VectorLanczosResult:
    """m-step single-vector Lanczos run in restartable chunks.

    If `path` exists and `resume`, continues from the saved state; a
    checkpoint is (re)written after every chunk.  Matches
    `vector_lanczos(..., reorth='none')` exactly.
    """
    lc_idx = jnp.asarray(0 if lc is None else lc, jnp.int32)

    if path and resume and os.path.exists(path):
        ck = LanczosCheckpoint.load(path)
        assert ck.m == m, "checkpoint was for a different m"
        j = ck.j
        alphas = ck.alphas.copy()
        betas = ck.betas.copy()
        trace = ck.trace.copy()
        q_prev = jnp.asarray(ck.q_prev)
        w = jnp.asarray(ck.w)
    else:
        beta0 = _norm(b)
        q0 = b / beta0
        w = a.mv(q0)
        alpha0 = jnp.sum(w * q0)
        w = w - alpha0 * q0
        dt = np.dtype(b.dtype)
        alphas = np.zeros(m, dt)
        betas = np.zeros(m, dt)
        trace = np.zeros(m, dt)
        alphas[0] = float(alpha0)
        betas[0] = float(beta0)
        if trace_fn is not None:
            trace[0] = float(trace_fn(q0))
        else:
            qf = q0.reshape(-1) if q0.ndim > 1 else q0
            trace[0] = float(qf[int(lc_idx)])
        q_prev = q0
        j = 1

    while j < m:
        k = min(chunk, m - j)
        q_prev, w, al, be, tr = _chunk_steps_jit(
            a, q_prev, w, lc_idx, trace_fn, k
        )
        alphas[j : j + k] = np.asarray(al)
        betas[j : j + k] = np.asarray(be)
        trace[j : j + k] = np.asarray(tr)
        j += k
        if path:
            LanczosCheckpoint(
                j=j, m=m, alphas=alphas, betas=betas, trace=trace,
                q_prev=np.asarray(q_prev), w=np.asarray(w),
            ).save(path)

    return VectorLanczosResult(
        alphas=jnp.asarray(alphas),
        betas=jnp.asarray(betas),
        trace=jnp.asarray(trace),
        basis=None,
        breakdown=jnp.asarray(False),
        beta_final=_norm(w),
    )


@dataclasses.dataclass
class BlockLanczosCheckpoint:
    """Exact state of a paused block-Lanczos run (reorth='none')."""

    j: int
    m: int
    alphas: np.ndarray  # (m, p, p)
    betas: np.ndarray  # (m, p, p)
    trace: np.ndarray  # (m, p)
    q_prev: np.ndarray  # (p, *state)
    w: np.ndarray  # (p, *state)

    def save(self, path: str) -> None:
        _atomic_savez(path, **dataclasses.asdict(self))

    @classmethod
    def load(cls, path: str) -> "BlockLanczosCheckpoint":
        z = np.load(path)
        return cls(
            j=int(z["j"]), m=int(z["m"]), alphas=z["alphas"],
            betas=z["betas"], trace=z["trace"], q_prev=z["q_prev"], w=z["w"],
        )


def _block_chunk_steps(a, q_prev, w, lc_idx, trace_fn, eig_sweeps, n_steps):
    """n_steps bare block three-term iterations from (q_prev, w)."""
    from lanczos_tpu.methods.block_lanczos import _gram, _mix, _sym
    from lanczos_tpu.ops.smalleig import sqrtm_invsqrtm

    p = q_prev.shape[0]
    if trace_fn is None:
        from lanczos_tpu.ops.operator import state_trace

        def trace_at(q):
            return state_trace(q, lc_idx, block=True)
    else:
        trace_at = trace_fn

    def body(carry, _):
        q_prev, wv = carry
        beta, inv = sqrtm_invsqrtm(_gram(wv, wv), sweeps=eig_sweeps)
        q = _mix(inv, wv)
        wn = a.mm(q) - _mix(beta, q_prev)
        alpha = _sym(_gram(wn, q))
        wn = wn - _mix(alpha, q)
        return (q, wn), (alpha, beta, trace_at(q))

    (q, wn), (al, be, tr) = jax.lax.scan(
        body, (q_prev, w), None, length=n_steps
    )
    return q, wn, al, be, tr


_block_chunk_steps_jit = jax.jit(
    _block_chunk_steps, static_argnames=("n_steps", "trace_fn", "eig_sweeps")
)


def block_lanczos_checkpointed(
    a,
    b: jax.Array,
    m: int,
    lc=None,
    *,
    chunk: int = 64,
    path: str | None = None,
    resume: bool = True,
    trace_fn=None,
    eig_sweeps: int | None = None,
):
    """m-step block Lanczos in restartable chunks; matches
    `block_lanczos(..., reorth='none', fused=False)` exactly (the
    materialized recurrence; the fused fast path agrees to rounding).
    b is BLOCK-MAJOR (p, *state).  Returns a BlockLanczosResult
    (basis=None)."""
    from lanczos_tpu.methods.block_lanczos import (
        BlockLanczosResult,
        _gram,
        _mix,
        _sym,
    )
    from lanczos_tpu.ops.smalleig import sqrtm_invsqrtm

    p = b.shape[0]
    lc_idx = jnp.asarray(0 if lc is None else lc, jnp.int32)

    if path and resume and os.path.exists(path):
        ck = BlockLanczosCheckpoint.load(path)
        assert ck.m == m, "checkpoint was for a different m"
        j = ck.j
        alphas, betas, trace = ck.alphas.copy(), ck.betas.copy(), ck.trace.copy()
        q_prev, w = jnp.asarray(ck.q_prev), jnp.asarray(ck.w)
    else:
        beta0, inv0 = sqrtm_invsqrtm(_gram(b, b), sweeps=eig_sweeps)
        q0 = _mix(inv0, b)
        w = a.mm(q0)
        alpha0 = _sym(_gram(w, q0))
        w = w - _mix(alpha0, q0)
        dt = np.dtype(b.dtype)
        alphas = np.zeros((m, p, p), dt)
        betas = np.zeros((m, p, p), dt)
        trace = np.zeros((m, p), dt)
        alphas[0] = np.asarray(alpha0)
        betas[0] = np.asarray(beta0)
        if trace_fn is not None:
            trace[0] = np.asarray(trace_fn(q0))
        else:
            trace[0] = np.asarray(q0.reshape(p, -1)[:, int(lc_idx)])
        q_prev = q0
        j = 1

    while j < m:
        k = min(chunk, m - j)
        q_prev, w, al, be, tr = _block_chunk_steps_jit(
            a, q_prev, w, lc_idx, trace_fn, eig_sweeps, k
        )
        alphas[j : j + k] = np.asarray(al)
        betas[j : j + k] = np.asarray(be)
        trace[j : j + k] = np.asarray(tr)
        j += k
        if path:
            BlockLanczosCheckpoint(
                j=j, m=m, alphas=alphas, betas=betas, trace=trace,
                q_prev=np.asarray(q_prev), w=np.asarray(w),
            ).save(path)

    beta_final, _ = sqrtm_invsqrtm(_gram(w, w), sweeps=eig_sweeps)
    return BlockLanczosResult(
        alphas=jnp.asarray(alphas),
        betas=jnp.asarray(betas),
        trace=jnp.asarray(trace),
        basis=None,
        beta_final=beta_final,
    )


@jax.jit
def _fdtd_chunk_mv(u, k_arr, a, dt):
    def body(i, u):
        return u + dt * a.mv(u)
    return jax.lax.fori_loop(0, k_arr, body, u)


@jax.jit
def _fdtd_chunk_mm(u, k_arr, a, dt):
    def body(i, u):
        return u + dt * a.mm(u)
    return jax.lax.fori_loop(0, k_arr, body, u)


def fdtd_checkpointed(
    a,
    u0: jax.Array,
    nsteps: int,
    t_end: float,
    *,
    chunk: int = 100_000,
    path: str | None = None,
    resume: bool = True,
    block: bool = False,
) -> jax.Array:
    """Forward-Euler u += dt A u in restartable chunks (the reference's
    10^6-step oracle, fdtd.hpp:7 / ftdt_block fdtd.hpp:34, with resume).
    `block=True` integrates a block-major (p, *state) state via a.mm.

    The operator is a jit ARGUMENT (not a closure constant — a closed-over
    assembled matrix would be re-embedded per compile, the failure mode
    commit dc47c04 fixed in the benches)."""
    dt = jnp.asarray(float(t_end) / nsteps, u0.dtype)

    start = 0
    u = u0
    if path and resume and os.path.exists(path):
        z = np.load(path)
        if int(z["nsteps"]) == nsteps and float(z["t_end"]) == float(t_end):
            start = int(z["step"])
            u = jnp.asarray(z["u"])

    run_chunk = _fdtd_chunk_mm if block else _fdtd_chunk_mv
    while start < nsteps:
        k = min(chunk, nsteps - start)
        u = run_chunk(u, k, a, dt)
        start += k
        if path:
            _atomic_savez(
                path, u=np.asarray(u), step=start, nsteps=nsteps,
                t_end=t_end,
            )
    return u
