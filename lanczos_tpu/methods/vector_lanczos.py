"""Single-vector Lanczos tridiagonalization as a `lax.scan`.

Same three-term recurrence as the reference (`methods/vector_lanczos.hpp:9-67`)
with the accelerator execution model: alpha/beta live in the scan carry on
device (the reference's BLAS path syncs a host scalar per dot/nrm2,
`vector_lanczos.hpp:84,96` — SURVEY.md §2 "Device<->host scalar sync" row).

Beyond the reference (north-star requirements):
  * `reorth="full"`: twice-iterated classical Gram-Schmidt of the residual
    against the stored basis every step (the reference runs the bare
    recurrence and loses orthogonality);
  * `reorth="selective"`: Simon's omega-recurrence estimate of
    orthogonality loss; reorthogonalize only when max omega > sqrt(eps);
  * breakdown guard: beta below `breakdown_tol * beta0` freezes the
    recurrence instead of dividing by ~0 (the reference only aborts on
    non-finite norms, `vector.hpp:236`).

Known reference bug NOT replicated: `vector_lanczos_blas` updates q0
instead of w in the beta-axpy (`vector_lanczos.hpp:116`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from lanczos_tpu.ops.precision import HIGHEST

from lanczos_tpu.ops.operator import LinearOperator


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class VectorLanczosResult:
    """alphas: (m,); betas: (m,) with betas[0] = ||b|| and betas[1:] the
    subdiagonal of T; trace: (m,) basis value at index lc per iteration
    (meaningful only when lc was given); basis: (m, n) Krylov basis if
    requested, else None; breakdown: True if the recurrence hit an
    (approximate) invariant subspace and was frozen; beta_final: the true
    beta_m = ||w_m|| of the completed m-step factorization (the residual
    left in the scan carry — NOT betas[-1], which is beta_{m-1}), for the
    |beta_m s_{m,i}| Ritz residual bound."""

    alphas: jax.Array
    betas: jax.Array
    trace: jax.Array
    basis: jax.Array | None
    breakdown: jax.Array
    beta_final: jax.Array


def _norm(x):
    return jnp.sqrt(jnp.sum(x * x))


def _cgs2(wv, basis, valid_mask):
    """Twice-iterated classical Gram-Schmidt: w -= Q (Q^T w), masked to the
    currently valid basis rows.  Two matmul-shaped products per pass; works
    for any state shape (basis is (m, *state))."""
    for _ in range(2):
        coeffs = jnp.einsum("k...,...->k", basis, wv, precision=HIGHEST)
        wv = wv - jnp.einsum("k,k...->...", valid_mask * coeffs, basis,
                         precision=HIGHEST)
    return wv


@partial(
    jax.jit,
    static_argnames=("m", "reorth", "store_basis", "breakdown_tol", "trace_fn",
                     "fused"),
)
def vector_lanczos(
    a: LinearOperator,
    b: jax.Array,
    m: int,
    lc: jax.Array | int | None = None,
    *,
    reorth: str = "none",
    store_basis: bool = False,
    breakdown_tol: float = 0.0,
    trace_fn=None,
    fused: bool | None = None,
) -> VectorLanczosResult:
    """b may have ANY state shape the operator accepts (a flat (n,) vector
    for matrix formats; e.g. the stacked-field layout of the stacked
    Maxwell operator).  `trace_fn(q) -> scalar` overrides the default
    receiver extraction (flat index lc) for non-flat states.

    fused=None (auto): bare-recurrence single-device runs whose state
    reaches fused_min_bytes(1) route through the traffic-minimal fused
    recurrence at block width 1 (`block_lanczos_fused.py` — 3 state
    passes per iteration instead of ~6).  fused=False forces the classic
    materialized scan."""
    if reorth not in ("none", "full", "selective"):
        raise ValueError(f"unknown reorth mode {reorth!r}")
    from lanczos_tpu.methods.block_lanczos import fused_min_bytes

    big_enough = b.size * jnp.dtype(b.dtype).itemsize >= fused_min_bytes(1)
    fusable = (
        reorth == "none"
        and breakdown_tol == 0.0
        and getattr(a, "mesh", None) is None
    )
    if fused and not fusable:
        raise ValueError(
            "fused=True requires reorth='none', breakdown_tol=0 and a "
            "non-distributed operator"
        )
    if fusable and (fused or (fused is None and big_enough)):
        from lanczos_tpu.methods.block_lanczos_fused import (
            block_lanczos_fused,
        )

        btrace = None
        if trace_fn is not None:
            btrace = lambda q: jnp.reshape(trace_fn(q[0]), (1,))
        r = block_lanczos_fused(
            a, b[None], m, lc, store_basis=store_basis, trace_fn=btrace
        )
        return VectorLanczosResult(
            alphas=r.alphas[:, 0, 0],
            betas=r.betas[:, 0, 0],
            trace=r.trace[:, 0],
            basis=r.basis[:, 0] if r.basis is not None else None,
            breakdown=(
                r.breakdown
                if r.breakdown is not None
                else jnp.asarray(False)
            ),
            beta_final=r.beta_final[0, 0],
        )
    need_basis = store_basis or reorth in ("full", "selective")
    n = b.size
    dtype = b.dtype
    eps = jnp.finfo(dtype).eps
    sqrt_eps = jnp.sqrt(eps)
    lc_idx = jnp.asarray(0 if lc is None else lc, jnp.int32)

    if trace_fn is None:
        from lanczos_tpu.ops.operator import state_trace

        def trace_at(q):
            return state_trace(q, lc_idx, block=False)
    else:
        trace_at = trace_fn

    beta0 = _norm(b)
    q0 = b / beta0
    w = a.mv(q0)
    alpha0 = jnp.sum(w * q0)
    w = w - alpha0 * q0

    karr = jnp.arange(m)
    if need_basis:
        basis0 = jnp.zeros((m,) + b.shape, dtype).at[0].set(q0)
    else:
        basis0 = jnp.zeros((1,) + b.shape, dtype)  # placeholder, never read

    # histories indexed by k: alph_hist[k] = alpha_k, beta_hist[k] = beta_k
    # (beta_0 := ||b||); omega = omega_{j-1,.}, omega_prev = omega_{j-2,.}
    alph_hist0 = jnp.zeros((m,), dtype).at[0].set(alpha0)
    beta_hist0 = jnp.zeros((m,), dtype).at[0].set(beta0)
    omega0 = jnp.zeros((m,), dtype).at[0].set(1.0)

    def body(carry, j):
        (q_prev, wv, basis, om_prev, om, alph_hist, beta_hist, dead, force) = carry

        if reorth == "selective":
            # Estimate omega_{j,k} ~ q_j . q_k via the three-term recurrence
            # (Simon '84):
            #   beta_j * omega_{j,k} = (alpha_k - alpha_{j-1}) w_{j-1,k}
            #     + beta_{k+1} w_{j-1,k+1} + beta_k w_{j-1,k-1}
            #     - beta_{j-1} w_{j-2,k},
            # with beta_0 := 0 here (no q_{-1}) and a rounding-noise floor
            # so the estimate can seed and grow.
            beta_tent = jnp.maximum(_norm(wv), jnp.finfo(dtype).tiny)
            bh = beta_hist.at[0].set(0.0)
            b_kp1 = jnp.roll(bh, -1)
            om_kp1 = jnp.roll(om, -1)
            om_km1 = jnp.roll(om, 1)
            alpha_jm1 = jnp.take(alph_hist, j - 1)
            beta_jm1 = jnp.take(bh, j - 1)
            tilde = (
                (alph_hist - alpha_jm1) * om
                + b_kp1 * om_kp1
                + bh * om_km1
                - beta_jm1 * om_prev
            )
            om_new = tilde / beta_tent + eps * (b_kp1 + beta_tent) / beta_tent
            seed = eps * n * jnp.take(bh, 1) / beta_tent
            om_new = jnp.where(karr == j - 1, seed, om_new)
            om_new = jnp.where(karr == j, 1.0, om_new)
            om_new = jnp.where(karr > j, 0.0, om_new)
            older = karr <= (j - 2)
            trigger = force | (
                jnp.max(jnp.abs(jnp.where(older, om_new, 0.0))) > sqrt_eps
            )
            valid = (karr <= j - 1).astype(dtype)
            wv = jax.lax.cond(
                trigger, lambda v: _cgs2(v, basis, valid), lambda v: v, wv
            )
            om_new = jnp.where(trigger & (karr <= j - 1), eps, om_new)
            # reorthogonalize the following step too (standard pairing)
            force = trigger & jnp.logical_not(force)
            om_prev, om = om, om_new

        beta = _norm(wv)
        is_dead = dead | (beta <= breakdown_tol * beta0)
        beta_safe = jnp.where(is_dead, jnp.asarray(1.0, dtype), beta)
        q = jnp.where(is_dead, jnp.zeros_like(wv), wv / beta_safe)
        beta_out = jnp.where(is_dead, jnp.asarray(0.0, dtype), beta)

        wn = a.mv(q) - beta_out * q_prev
        alpha = jnp.sum(wn * q)
        wn = wn - alpha * q

        if need_basis:
            basis = jax.lax.dynamic_update_index_in_dim(basis, q, j, 0)
        if reorth == "full":
            valid = (karr <= j).astype(dtype)
            wn = _cgs2(wn, basis, valid)

        alph_hist = jax.lax.dynamic_update_index_in_dim(alph_hist, alpha, j, 0)
        beta_hist = jax.lax.dynamic_update_index_in_dim(beta_hist, beta_out, j, 0)

        out = (alpha, beta_out, trace_at(q))
        return (
            (q, wn, basis, om_prev, om, alph_hist, beta_hist, is_dead, force),
            out,
        )

    carry0 = (
        q0,
        w,
        basis0,
        jnp.zeros((m,), dtype),
        omega0,
        alph_hist0,
        beta_hist0,
        jnp.asarray(False),
        jnp.asarray(False),
    )
    if m > 1:
        carry, (alphas_r, betas_r, traces_r) = jax.lax.scan(
            body, carry0, jnp.arange(1, m)
        )
        basis_final = carry[2]
        dead_final = carry[7]
        w_final = carry[1]
        alphas = jnp.concatenate([alpha0[None], alphas_r])
        betas = jnp.concatenate([beta0[None], betas_r])
        trace = jnp.concatenate([trace_at(q0)[None], traces_r])
    else:
        basis_final = basis0
        dead_final = jnp.asarray(False)
        w_final = w
        alphas = alpha0[None]
        betas = beta0[None]
        trace = trace_at(q0)[None]

    return VectorLanczosResult(
        alphas=alphas,
        betas=betas,
        trace=trace,
        basis=basis_final if store_basis else None,
        breakdown=dead_final,
        beta_final=jnp.where(
            dead_final, jnp.asarray(0.0, dtype), _norm(w_final)
        ),
    )
