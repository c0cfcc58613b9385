"""Traffic-minimal ("fused") block Lanczos: the residual is never stored.

The standard recurrence (`block_lanczos.py`, mirroring reference
`methods/block_lanczos.hpp:13-80`) spends ~15 full state passes per
iteration across six separate ops (Gram, sqrtm-mix, SpMM, two fused
subtracts, cross-Gram).  At Lanczos block widths every one of those is
memory-bound, so the iteration cost is traffic.  This path reorganizes
the algebra so each iteration runs exactly THREE big-array passes:

  1. ``q_j   = block_mix(E, (q_{j-2}, q_{j-1}, v_{j-1}))``  (4S traffic)
  2. ``v_j   = A @ q_j``                                    (2S)
  3. ``block_grams((q_j,), v_j, include_zz)``               (2S)

where v = A q is the RAW operator application and E is a (3p, p)
coefficient matrix computed from p x p algebra only.  The key identities:

* the residual w_j = v_j - q_{j-1} beta_j^T - q_j alpha_j is a linear
  combination of (q_{j-1}, q_j, v_j), so its Gram matrix — and hence
  beta_{j+1} = sqrtm(w^T w) and the normalization inv — follow from the
  3p x 3p Gram blocks M of that triple without materializing w;
* normalization composes into the same combination: q_{j+1} = w inv =
  block_mix([-beta^T inv; -alpha inv; inv], triple);
* by symmetry of A, gram(q_{j-1}, v_j) = gram(A q_{j-1}, q_j)
  = gram(v_{j-1}, q_j), which is derivable from M and E — so pass 3 only
  needs gram(q_j, v_j) and gram(v_j, v_j).

Semantics: identical to `block_lanczos(reorth='none',
normalize='sqrtm')` in exact arithmetic; in f32 the deferred Gram
computation differs from the materialized one at the
O(eps * ||v||^2 / ||w||^2) level (mild cancellation when the residual is
much smaller than A q — the usual regime ||w|| ~ ||A|| keeps this near
eps).  A is assumed numerically symmetric (it is the Lanczos
prerequisite anyway).  For reorthogonalized / QR / adaptive runs use the
standard path — those need the materialized basis.

Time per iteration against the materialized path on the card: PERF.md.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lanczos_tpu.ops.operator import LinearOperator
from lanczos_tpu.ops.block_dense import block_grams, block_mix
from lanczos_tpu.ops.precision import HIGHEST
from lanczos_tpu.ops.smalleig import sqrtm_invsqrtm


def _sym(g):
    return 0.5 * (g + g.T)


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


def _fro(x):
    return jnp.sqrt(jnp.sum(x * x))


@partial(
    jax.jit,
    static_argnames=(
        "m",
        "store_basis",
        "eig_backend",
        "eig_sweeps",
        "breakdown_eps",
        "breakdown_tol",
        "trace_fn",
        "compensated",
    ),
)
def block_lanczos_fused(
    a: LinearOperator,
    b: jax.Array,
    m: int,
    lc=None,
    *,
    store_basis: bool = False,
    eig_backend: str = "jacobi",
    eig_sweeps: int | None = None,
    breakdown_eps: float = 0.0,
    breakdown_tol: float = 0.0,
    trace_fn=None,
    compensated: bool = False,
):
    """Drop-in for `block_lanczos(..., reorth='none', normalize='sqrtm')`.
    Returns the same `BlockLanczosResult`.  See module docstring.

    compensated=True accumulates every Gram product, and runs the p x p
    coefficient algebra, in float64 from the stored states (needs
    jax_enable_x64): the T coefficients are then accurate to O(eps) of
    the state dtype instead of O(eps*sqrt(n)) — the reference's all-f64
    block driver accuracy (`test_lanczos.cu:349-356`) from f32 storage."""
    from lanczos_tpu.methods.block_lanczos import BlockLanczosResult

    p = b.shape[0]
    dtype = b.dtype
    lc_idx = jnp.asarray(0 if lc is None else lc, jnp.int32)

    if trace_fn is None:
        from lanczos_tpu.ops.operator import state_trace

        def trace_at(q):
            return state_trace(q, lc_idx, block=True)
    else:
        trace_at = trace_fn

    cdt = jnp.float64 if compensated else jnp.promote_types(jnp.float32, dtype)

    def sqrtm_inv(g):
        if p == 1:
            # scalar block: sqrtm is sqrt, pinv is a guarded reciprocal —
            # skip the (padded) Jacobi machinery entirely
            s_ = jnp.sqrt(jnp.abs(g.astype(cdt)))
            ok = s_ > 0
            return s_, jnp.where(ok, 1.0 / jnp.where(ok, s_, 1.0), 0.0)
        return sqrtm_invsqrtm(
            g.astype(cdt),
            backend=eig_backend,
            sweeps=eig_sweeps,
            breakdown_eps=breakdown_eps,
        )

    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    def grams(xs, z):
        return block_grams(xs, z, include_zz=True, acc_dtype=cdt)

    def norm_coeffs(gwn, dead):
        """(beta, inv, rcond, dead') from the residual Gram; freezes to
        zeros once the reciprocal condition estimate crosses
        breakdown_tol (same semantics as the standard path)."""
        beta, inv = sqrtm_inv(gwn)
        rcond = 1.0 / jnp.maximum(_fro(inv) * _fro(beta), tiny)
        if breakdown_tol > 0.0:
            # an EXACTLY invariant subspace gives beta = inv = 0 (pinv),
            # which the product-of-norms estimate reads as healthy —
            # catch it by the vanished residual norm itself
            dead = dead | (rcond <= breakdown_tol) | (_fro(beta) <= tiny)
            beta = jnp.where(dead, jnp.zeros_like(beta), beta)
            inv = jnp.where(dead, jnp.zeros_like(inv), inv)
        return beta, inv, dead

    # ---- prologue: q0, v0 = A q0, alpha0 -------------------------------
    gbb = grams((), b)  # (p, p): one read of b
    beta0, inv0 = sqrtm_inv(gbb)
    q0 = block_mix(inv0.astype(cdt), (b,))
    v0 = a.mm(q0)
    g2 = grams((q0,), v0)  # [gram(q0,v0); gram(v0,v0)]
    g_qv, g_vv = g2[:p], g2[p:]
    g_qq = _mm(_mm(inv0.T.astype(cdt), gbb), inv0.astype(cdt))
    alpha0 = _sym(g_qv.T).astype(dtype)
    trace0 = trace_at(q0)

    if m == 1:
        s2 = alpha0.astype(cdt)
        gwn = (
            g_vv - _mm(g_qv.T, s2) - _mm(s2.T, g_qv) + _mm(s2.T, _mm(g_qq, s2))
        )
        beta_final, _ = sqrtm_inv(gwn)
        return BlockLanczosResult(
            alphas=alpha0[None],
            betas=beta0.astype(dtype)[None],
            trace=trace0[None],
            basis=q0[None] if store_basis else None,
            beta_final=beta_final.astype(dtype),
            breakdown=jnp.asarray(False),
        )

    # ---- peeled step j=1 (doublet U = (q0, v0)) ------------------------
    dead = jnp.asarray(False)
    s2 = alpha0.astype(cdt)
    gwn0 = g_vv - _mm(g_qv.T, s2) - _mm(s2.T, g_qv) + _mm(s2.T, _mm(g_qq, s2))
    beta1, inv1, dead = norm_coeffs(gwn0, dead)
    inv1f = inv1.astype(cdt)
    e1 = jnp.concatenate([-_mm(s2, inv1f), inv1f])  # (2p, p)
    q1 = block_mix(e1, (q0, v0))
    v1 = a.mm(q1)
    g2 = grams((q1,), v1)
    m23, m33 = g2[:p], g2[p:]
    # 2p x 2p gram of (q0, v0) for the derived blocks
    gU = jnp.block([[g_qq, g_qv], [g_qv.T, g_vv]])
    gq0U = jnp.concatenate([g_qq, g_qv], axis=1)  # (p, 2p)
    gv0U = jnp.concatenate([g_qv.T, g_vv], axis=1)
    m12 = _mm(gq0U, e1)  # gram(q0, q1)
    m22 = _mm(e1.T, _mm(gU, e1))  # gram(q1, q1)
    m13 = _mm(gv0U, e1)  # gram(q0, v1) = gram(v0, q1)
    m11 = g_qq
    alpha1 = _sym(m23.T - _mm(beta1.astype(cdt), m12)).astype(dtype)
    trace1 = trace_at(q1)

    def gwn_from(M, s1, s2):
        m11, m12, m13, m22, m23, m33 = M
        t1 = _mm(m13.T, s1)
        t2 = _mm(m23.T, s2)
        return (
            m33
            - t1
            - t2
            - t1.T
            - t2.T
            + _mm(s1.T, _mm(m11, s1))
            + _mm(s1.T, _mm(m12, s2))
            + _mm(s2.T, _mm(m12.T, s1))
            + _mm(s2.T, _mm(m22, s2))
        )

    def body_step(u1, u2, u3, M, alpha_prev, beta_prev, dead):
        m11, m12, m13, m22, m23, m33 = M
        s1 = beta_prev.T.astype(cdt)
        s2 = alpha_prev.astype(cdt)
        gwn = gwn_from(M, s1, s2)
        beta_j, inv_j, dead = norm_coeffs(gwn, dead)
        invf = inv_j.astype(cdt)
        e = jnp.concatenate([-_mm(s1, invf), -_mm(s2, invf), invf])  # (3p,p)
        e = jnp.where(dead, jnp.zeros_like(e), e)
        gu2U = jnp.concatenate([m12.T, m22, m23], axis=1)  # (p, 3p)
        q_j = block_mix(e, (u1, u2, u3))
        v_j = a.mm(q_j)
        g2 = grams((q_j,), v_j)
        m23n, m33n = g2[:p], g2[p:]
        gu3U = jnp.concatenate([m13.T, m23.T, m33], axis=1)
        m13n = _mm(gu3U, e)  # gram(u2, v_j) = gram(u3, q_j)  [A sym.]
        m12n = _mm(gu2U, e)  # gram(u2, q_j)
        Mfull = jnp.block(
            [[m11, m12, m13], [m12.T, m22, m23], [m13.T, m23.T, m33]]
        )
        m22n = _mm(e.T, _mm(Mfull, e))  # gram(q_j, q_j)
        alpha_j = _sym(m23n.T - _mm(beta_j.astype(cdt), m12n)).astype(
            dtype
        )
        new_M = (m22, m12n, m13n, m22n, m23n, m33n)
        out = (alpha_j, beta_j.astype(dtype), trace_at(q_j))
        if store_basis:
            out = out + (q_j,)
        return (u2, q_j, v_j, new_M, alpha_j, beta_j, dead), out

    def body(carry, _):
        return body_step(*carry)

    M1 = (m11, m12, m13, m22, m23, m33)
    carry0 = (q0, q1, v1, M1, alpha1, beta1, dead)
    if m > 2:
        carry, outs = jax.lax.scan(body, carry0, None, length=m - 2)
    else:
        carry, outs = carry0, None

    (_, _, _, M_f, alpha_f, beta_f, dead_f) = carry
    gwn_f = gwn_from(
        M_f, beta_f.T.astype(cdt), alpha_f.astype(cdt)
    )
    beta_final, _ = sqrtm_inv(gwn_f)
    beta_final = jnp.where(
        dead_f, jnp.zeros_like(beta_final), beta_final
    ).astype(dtype)

    if outs is not None:
        alphas_r, betas_r, traces_r = outs[0], outs[1], outs[2]
        alphas = jnp.concatenate([alpha0[None], alpha1[None], alphas_r])
        betas = jnp.concatenate(
            [beta0.astype(dtype)[None], beta1.astype(dtype)[None], betas_r]
        )
        trace = jnp.concatenate([trace0[None], trace1[None], traces_r])
        basis = (
            jnp.concatenate([q0[None], q1[None], outs[3]])
            if store_basis
            else None
        )
    else:
        alphas = jnp.stack([alpha0, alpha1])
        betas = jnp.stack([beta0.astype(dtype), beta1.astype(dtype)])
        trace = jnp.stack([trace0, trace1])
        basis = jnp.stack([q0, q1]) if store_basis else None

    return BlockLanczosResult(
        alphas=alphas,
        betas=betas,
        trace=trace,
        basis=basis,
        beta_final=beta_final,
        breakdown=dead_f,
    )
