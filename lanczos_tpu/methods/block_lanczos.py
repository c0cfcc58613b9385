"""Block Lanczos tridiagonalization as a `lax.scan`.

Same recurrence as the reference (`methods/block_lanczos.hpp:13-80`):
  beta_0^2 = B^T B;  Q_0 = B * invsqrtm(beta_0^2)
  W = A Q_0;  alpha_0 = sym(W^T Q_0);  W -= Q_0 alpha_0
  loop j = 1..m-1:
    beta_j = sqrtm(W^T W);  Q_1 = W * invsqrtm(W^T W)
    W = A Q_1 - Q_0 beta_j
    alpha_j = 0.5 (W^T Q_1 + Q_1^T W);  W -= Q_1 alpha_j

BLOCK-MAJOR convention: B has shape (p, *state_shape) — the block axis
leads (each block column is one contiguous state), unlike the
reference's column-major tall (n, p) matrices.  The state may be a flat
(n,) vector or any richer operator state (e.g. the stacked Maxwell
field layout).

All dense block math (Gram products `mm_tt`/`mm_tt2`, tall x small updates
`mm_ts` — reference `kernels/mm_tt.hpp`, `mm_tt2.hpp`, `mm_ts.hpp`) is
expressed as einsum/`dot_general` at precision HIGHEST; the per-iteration
sqrtm/inv-sqrtm uses the in-graph Jacobi eigensolver (`ops/smalleig.py`)
instead of the warp-level kernel (`kernels/my_sqrtm_cusolver.hpp`) or
syevjBatched.

Beyond the reference: full/periodic block re-orthogonalization against
the stored basis, and rank-revealing pseudo-inverse handling of block
breakdown.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from lanczos_tpu.ops.precision import HIGHEST

from lanczos_tpu.ops.operator import LinearOperator
from lanczos_tpu.ops.smalleig import sqrtm_invsqrtm
from lanczos_tpu.ops.tsqr import tsqr, tsqr_sharded


def fused_min_bytes(p: int) -> int:
    """Block-state bytes from which bare runs take the fused recurrence.

    Per iteration on an H100 (700 W), fused vs materialized, Maxwell
    stencil: p=1 at 0.35 MB 73.7 vs 39.7 us, 1.6 MB 35.7 vs 28.8 us,
    6.4 MB 48.2 vs 45.9 us, 24 MB 142 vs 154 us, 99 MB 0.51 vs 0.57 ms;
    p=4 at 1.4 MB 385 vs 408 us, 397 MB 2.37 vs 8.03 ms."""
    return 16 * 1024 * 1024 if p == 1 else 1024 * 1024


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockLanczosResult:
    """alphas: (m, p, p); betas: (m, p, p) with betas[0] = sqrtm(B^T B) and
    betas[1:] the subdiagonal blocks; trace: (m, p) receiver value of each
    block column; basis: (m, p, *state) if requested; beta_final: (p, p)
    symmetric factor sqrtm(W_m^T W_m) of the completed m-step residual
    block (the true beta_m; betas[-1] is beta_{m-1}), for the
    ||beta_m S_{m,i}|| Ritz residual bound."""

    alphas: jax.Array
    betas: jax.Array
    trace: jax.Array
    basis: jax.Array | None
    beta_final: jax.Array
    # True if the recurrence hit an (approximately) invariant subspace and
    # was frozen (breakdown_tol > 0); trailing alpha/beta/trace rows are 0.
    breakdown: jax.Array | None = None


def _sym(g):
    return 0.5 * (g + g.T)


def _gram(x, y):
    """x^T y over the state axes -> (p, q) (reference mm_tt /
    mm_tt2 kernels); x: (p, *state), y: (q, *state)."""
    return jnp.einsum("p...,q...->pq", x, y, preferred_element_type=x.dtype, precision=HIGHEST)


def _mix(s, x):
    """Columns-combination x <- s^T-applied block: out[j] = sum_k s[k,j] x[k]
    (the reference's tall x small mm_ts, block-major)."""
    return jnp.einsum("kj,k...->j...", s, x, preferred_element_type=x.dtype, precision=HIGHEST)


@partial(
    jax.jit,
    static_argnames=(
        "m",
        "reorth",
        "store_basis",
        "eig_backend",
        "eig_sweeps",
        "breakdown_eps",
        "breakdown_tol",
        "trace_fn",
        "normalize",
        "replace_dead",
        "restart_seed",
        "fused",
        "compensated",
    ),
)
def block_lanczos(
    a: LinearOperator,
    b: jax.Array,
    m: int,
    lc: jax.Array | int | None = None,
    *,
    reorth: str = "none",
    store_basis: bool = False,
    eig_backend: str = "jacobi",
    eig_sweeps: int | None = None,
    breakdown_eps: float = 0.0,
    breakdown_tol: float = 0.0,
    trace_fn=None,
    normalize: str = "sqrtm",
    replace_dead: bool = False,
    restart_seed: int = 17,
    fused: bool | None = None,
    compensated: bool = False,
) -> BlockLanczosResult:
    """b: (p, *state_shape), block-major.  `trace_fn(q) -> (p,)` overrides
    the default receiver extraction (flat index lc per block column).

    normalize: "sqrtm" (the reference's beta_j = sqrtm(W^T W), symmetric
    blocks) or "qr" (TSQR: beta_j = R upper triangular — never squares the
    condition number; BASELINE.json config 3's TSQR re-orth variant).  The
    downstream T assembly handles both (betas placed on the subdiagonal,
    transposes on the superdiagonal).

    breakdown_tol > 0 FREEZES the recurrence (the block analogue of
    vector_lanczos's guard) once the reciprocal condition estimate
    sigma_min(beta_j)/||beta_j||_F falls below breakdown_tol: a converged
    invariant subspace makes the residual Gram numerically singular,
    after which the inverse factor amplifies rounding noise and Ritz
    values ESCAPE the spectrum — unlike the scalar recurrence, whose
    no-reorth drift Paige's analysis bounds, the unfrozen block
    recurrence diverges even in f64.  Frozen steps emit zero
    alpha/beta/trace rows (spectrally inert for top-k) and the result's
    `breakdown` flag is set.  Use ~3e-3 (f32) / ~3e-6 (f64) for
    reorth='none' runs; per-direction deflation at milder conditioning is
    available separately via breakdown_eps (rank-revealing pinv).

    replace_dead=True (requires normalize='qr', breakdown_eps > 0, and a
    basis-keeping reorth mode) turns the freeze into ADAPTIVE block
    Lanczos: directions whose R diagonal collapses below
    breakdown_eps * max|R_ii| — converged invariant directions whose
    residual is pure rounding noise — are replaced by fresh deterministic
    random vectors orthogonalized against the stored basis and
    re-orthonormalized (TSQR), with their beta rows zeroed (the restart
    decouples them from the previous block in T).  This keeps the FULL
    block width hunting for interior eigenvalues after the dominant modes
    converge, instead of dragging amplified noise through the recurrence
    (the failure mode on matrices with a few well-separated modes: the
    residual block goes numerically rank-deficient within 2-3 steps and
    unfrozen Ritz values escape the spectrum).  The reference has no
    analogue — its sqrtm normalization divides by ~0 (spmv_spmm-era
    my_sqrtm semantics) and diverges."""
    if reorth not in ("none", "full", "periodic", "selective"):
        raise ValueError(f"unknown reorth mode {reorth!r}")
    if normalize not in ("sqrtm", "qr"):
        raise ValueError(f"unknown normalize mode {normalize!r}")
    # fused=None (auto): route reorth-free sqrtm single-device runs through
    # the traffic-minimal path (block_lanczos_fused.py — 3 state passes per
    # iteration instead of ~6 ops / 15 passes) once the block state reaches
    # fused_min_bytes(p).  fused=False forces the reference-semantics
    # materialized recurrence.
    fusable = (
        reorth == "none"
        and normalize == "sqrtm"
        and not replace_dead
        and getattr(a, "mesh", None) is None
    )
    big_enough = (
        b.size * jnp.dtype(b.dtype).itemsize >= fused_min_bytes(b.shape[0])
    )
    if fused and not fusable:
        raise ValueError(
            "fused=True requires reorth='none', normalize='sqrtm', "
            "replace_dead=False and a non-distributed operator"
        )
    if compensated and not fusable:
        raise ValueError(
            "compensated=True (float64 Gram accumulation) is implemented "
            "on the fused path: requires reorth='none', normalize='sqrtm' "
            "and a non-distributed operator"
        )
    if compensated and fused is False:
        # ADVICE r4: --no-fused --compensated used to silently run fused
        raise ValueError(
            "compensated=True is only implemented on the fused path; "
            "fused=False contradicts it (drop one of the two)"
        )
    if fusable and (fused or compensated or (fused is None and big_enough)):
        from lanczos_tpu.methods.block_lanczos_fused import (
            block_lanczos_fused,
        )

        return block_lanczos_fused(
            a,
            b,
            m,
            lc,
            store_basis=store_basis,
            eig_backend=eig_backend,
            eig_sweeps=eig_sweeps,
            breakdown_eps=breakdown_eps,
            breakdown_tol=breakdown_tol,
            trace_fn=trace_fn,
            compensated=compensated,
        )
    if replace_dead and (
        normalize != "qr" or breakdown_eps <= 0.0 or reorth == "none"
    ):
        raise ValueError(
            "replace_dead=True requires normalize='qr', breakdown_eps > 0 "
            "and a basis-keeping reorth mode (full/periodic/selective)"
        )
    need_basis = store_basis or reorth in ("full", "periodic", "selective")
    p = b.shape[0]
    dtype = b.dtype
    lc_idx = jnp.asarray(0 if lc is None else lc, jnp.int32)

    if trace_fn is None:
        from lanczos_tpu.ops.operator import state_trace

        def trace_at(q):
            return state_trace(q, lc_idx, block=True)
    else:
        trace_at = trace_fn

    def sqrtm_inv(g):
        return sqrtm_invsqrtm(
            g, backend=eig_backend, sweeps=eig_sweeps, breakdown_eps=breakdown_eps
        )

    # distributed operators expose a mesh: normalize='qr' then runs the
    # communication-avoiding shard_map TSQR (local QRs + an O(p^2)
    # all-gathered R reduction) instead of gathering the O(n) block
    dist_mesh = getattr(a, "mesh", None)
    dist_axis = getattr(a, "axis", "rows")

    # Pin every big carry array to the operator's row sharding: without
    # the constraints GSPMD picks divergent intermediate shardings for
    # the reorth einsums and "involuntarily rematerializes" (fully
    # replicates) the block state and basis on every scan step — an
    # O(n*m) collective where the design promises O(halo).
    state_pspec = getattr(a, "state_pspec", None)
    if dist_mesh is not None and state_pspec is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        def _pin(x, extra_lead=1):
            spec = PartitionSpec(
                *(None,) * extra_lead, *tuple(state_pspec)
            )
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(dist_mesh, spec)
            )
    else:
        def _pin(x, extra_lead=1):
            return x

    def _fro(x):
        return jnp.sqrt(jnp.sum(x * x))

    def normalize_block(wv):
        """W = Q B (tall convention): returns block-major Q, B, and a
        SCALE-FREE reciprocal-condition estimate of B for the breakdown
        freeze — sigma_min(B)/||B||_F, with sigma_min bounded below by
        min |R_ii| (QR path) / 1 over ||inv||_F (sqrtm path)."""
        tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
        if normalize == "qr":
            if dist_mesh is not None:
                qT, r = tsqr_sharded(
                    wv.reshape(p, -1), dist_mesh, axis=dist_axis
                )
                qf = qT.T
            else:
                qf, r = tsqr(wv.reshape(p, -1).T)
            if breakdown_eps > 0.0:
                # rank guard matching the sqrtm path's pseudo-inverse
                # breakdown semantics: zero the Q columns (and R rows)
                # whose R diagonal has collapsed, instead of returning
                # arbitrary directions from a singular R.
                d = jnp.abs(jnp.diagonal(r))
                keep = (d > breakdown_eps * jnp.max(d)).astype(wv.dtype)
                qf = qf * keep[None, :]
                r = r * keep[:, None]
            # min |R_ii| OVERestimates sigma_min (an ill-conditioned R can
            # keep a large diagonal), so invert the p x p triangle:
            # 1/||R^-1||_F <= sigma_min.
            rsafe = r + jnp.where(
                jnp.abs(jnp.diagonal(r)) <= tiny, tiny, 0.0
            ) * jnp.eye(p, dtype=dtype)
            inv_r = jax.scipy.linalg.solve_triangular(
                rsafe, jnp.eye(p, dtype=dtype), lower=False
            )
            rcond = 1.0 / jnp.maximum(_fro(inv_r) * _fro(r), tiny)
            return qf.T.reshape(wv.shape), r, rcond
        beta, inv = sqrtm_inv(_gram(wv, wv))
        rcond = 1.0 / jnp.maximum(_fro(inv) * _fro(beta), tiny)
        # reference mm_ts (block_lanczos.hpp:34)
        return _mix(inv, wv), beta, rcond

    # -- first half-iteration -------------------------------------------------
    # (a degenerate START block is the caller's bug, not a breakdown —
    # its rcond is not checked)
    q0, beta0, _rcond0 = normalize_block(b)
    q0 = _pin(q0)
    w = a.mm(q0)
    alpha0 = _sym(_gram(w, q0))
    w = _pin(w - _mix(alpha0, q0))

    karr = jnp.arange(m)
    eps = jnp.finfo(dtype).eps
    sqrt_eps = jnp.sqrt(eps)
    if need_basis:
        basis0 = _pin(jnp.zeros((m,) + b.shape, dtype).at[0].set(q0), 2)
    else:
        basis0 = _pin(jnp.zeros((1,) + b.shape, dtype), 2)

    # Block-omega histories (selective reorth): Frobenius norms of the
    # alpha/beta blocks stand in for the scalar |alpha|/|beta| of Simon's
    # vector recurrence — a conservative block generalization (the true
    # growth factor is sigma_min(beta_j) <= ||beta_j||_F).
    na_hist0 = jnp.zeros((m,), dtype).at[0].set(_fro(alpha0))
    nb_hist0 = jnp.zeros((m,), dtype).at[0].set(_fro(beta0))
    omega0 = jnp.zeros((m,), dtype).at[0].set(1.0)

    if dist_mesh is not None:
        from jax.sharding import NamedSharding as _NS, PartitionSpec as _PS

        def _pin_rep(x):
            # small (m, p, p) coefficient tensors: explicitly replicated,
            # so GSPMD lowers the reduction einsum to local-dot + psum
            # instead of inventing a sharded-output strategy that forces
            # a full rematerialization of the operands
            return jax.lax.with_sharding_constraint(
                x, _NS(dist_mesh, _PS())
            )
    else:
        def _pin_rep(x):
            return x

    def block_cgs2(wv, basis, valid_mask):
        # W -= Q_k (Q_k^T W) over all valid blocks, twice (CGS2).
        for _ in range(2):
            coeffs = jnp.einsum(
                "ki...,j...->kij", basis, wv, preferred_element_type=dtype, precision=HIGHEST
            )
            coeffs = _pin_rep(coeffs) * valid_mask[:, None, None]
            wv = _pin(wv - jnp.einsum(
                "kij,ki...->j...", coeffs, basis, preferred_element_type=dtype, precision=HIGHEST
            ))
        return wv

    def body(carry, j):
        (q_prev, wv, basis, om_prev, om, na_hist, nb_hist, force, dead) = carry

        if reorth == "selective":
            # Block omega recurrence (Simon '84 generalized with block
            # Frobenius norms): estimate max_k ||Q_j^T Q_k|| and
            # reorthogonalize the residual only when it crosses sqrt(eps).
            nb_tent = jnp.maximum(_fro(wv), jnp.finfo(dtype).tiny)
            nbh = nb_hist.at[0].set(0.0)
            nb_kp1 = jnp.roll(nbh, -1)
            om_kp1 = jnp.roll(om, -1)
            om_km1 = jnp.roll(om, 1)
            na_jm1 = jnp.take(na_hist, j - 1)
            nb_jm1 = jnp.take(nbh, j - 1)
            tilde = (
                (na_hist + na_jm1) * om
                + nb_kp1 * om_kp1
                + nbh * om_km1
                + nb_jm1 * om_prev
            )
            om_new = tilde / nb_tent + eps * (nb_kp1 + nb_tent) / nb_tent
            seed = eps * b.size * jnp.take(nbh, 1) / nb_tent
            om_new = jnp.where(karr == j - 1, seed, om_new)
            om_new = jnp.where(karr == j, 1.0, om_new)
            om_new = jnp.where(karr > j, 0.0, om_new)
            older = karr <= (j - 2)
            trigger = force | (
                jnp.max(jnp.abs(jnp.where(older, om_new, 0.0))) > sqrt_eps
            )
            om_new = jnp.where(trigger & (karr <= j - 1), eps, om_new)
            force = trigger & jnp.logical_not(force)
            om_prev, om = om, om_new

        q, beta, rcond = normalize_block(wv)
        q = _pin(q)

        # POST-normalization basis cleanup.  Orthogonalizing only the
        # residual (the classic placement) is not enough: normalization
        # amplifies the residual's eps-level basis components by
        # 1/sigma_i in each nearly-dead direction, so q re-acquires
        # O(eps/breakdown_eps) overlap with converged basis vectors and
        # the computed T drifts off V^T A V (observed: 2.5e-2 overlap,
        # 1e-3-relative Ritz errors with tiny claimed bounds on a matrix
        # with well-separated converged modes).  Cleaning q itself —
        # CGS2 against the basis, within-block re-QR, and folding the
        # correction R_2 into beta — restores eps-level orthogonality at
        # eps-level T perturbation: the discarded basis components carry
        # weight (eps/sigma_i) * sigma_i = eps in the factorization
        # W = Q beta, because the amplified directions are exactly the
        # ones with tiny beta rows.
        if reorth == "full":
            # the 1/sigma amplification the q-side cleanup targets only
            # occurs near rank collapse; with breakdown_eps == 0 (no
            # near-dead handling requested) gate it at RUNTIME on the
            # observed conditioning of the normalization instead of
            # statically skipping (ADVICE r4: natural beta
            # ill-conditioning triggers the same drift) — well-
            # conditioned steps keep the r3 cost savings
            do_clean = (
                jnp.asarray(True)
                if (breakdown_eps > 0.0 or replace_dead)
                else rcond <= sqrt_eps
            )
        elif reorth == "periodic":
            do_clean = (j % 2) == 0
        elif reorth == "selective":
            do_clean = trigger
        else:
            do_clean = None
        if do_clean is not None:
            if breakdown_eps > 0.0:
                d0 = jnp.abs(jnp.diagonal(beta))
                keep = (d0 > breakdown_eps * jnp.max(d0)).astype(dtype)
            else:
                keep = jnp.ones((p,), dtype)
            if replace_dead:
                do_clean = do_clean | jnp.any(keep < 1.0)

            def _clean(qb):
                qv, bv = qb
                if replace_dead:
                    # adaptive restart (see docstring): refill collapsed
                    # directions with deterministic noise; the CGS2 +
                    # re-QR below turns it into fresh basis-orthogonal
                    # unit directions, and the zeroed beta rows decouple
                    # them from the previous block in T.
                    key = jax.random.fold_in(
                        jax.random.PRNGKey(restart_seed), j
                    )
                    mask = (1.0 - keep).reshape((p,) + (1,) * (qv.ndim - 1))
                    qv = qv + jax.random.normal(key, qv.shape, dtype) * mask
                valid = (karr <= j - 1).astype(dtype)
                qv = block_cgs2(qv, basis, valid)
                if dist_mesh is not None:
                    qT, r2 = tsqr_sharded(
                        qv.reshape(p, -1), dist_mesh, axis=dist_axis
                    )
                    qv = qT.reshape(qv.shape)
                else:
                    qf, r2 = tsqr(qv.reshape(p, -1).T)
                    qv = qf.T.reshape(qv.shape)
                bv = jnp.matmul(r2, bv, precision=HIGHEST)
                if not replace_dead:
                    # deflation: the within-block re-QR refills exactly-
                    # zero (collapsed) directions with arbitrary
                    # completion vectors — re-zero them
                    qv = qv * keep.reshape((p,) + (1,) * (qv.ndim - 1))
                bv = bv * keep[:, None]
                return qv, bv

            q, beta = jax.lax.cond(
                do_clean, _clean, lambda qb: qb, (q, beta)
            )
            q = _pin(q)
        if breakdown_tol > 0.0:
            # freeze on (approximate) invariant subspace: see docstring.
            # (an EXACTLY invariant one gives beta = pinv = 0, which the
            # product-of-norms rcond reads as healthy — catch the
            # vanished residual norm directly)
            tiny_t = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
            dead = dead | (rcond <= breakdown_tol) | (
                jnp.sqrt(jnp.sum(beta * beta)) <= tiny_t
            )
            q = jnp.where(dead, jnp.zeros_like(q), q)
            beta = jnp.where(dead, jnp.zeros_like(beta), beta)
        # A V_j = V_{j-1} B_j^T + V_j A_j + V_{j+1} B_{j+1}: subtract the
        # TRANSPOSED subdiagonal block (== beta for the symmetric sqrtm
        # path; required for the upper-triangular QR path).
        wn = a.mm(q) - _mix(beta.T, q_prev)
        alpha = _sym(_gram(wn, q))
        wn = _pin(wn - _mix(alpha, q))

        if need_basis:
            basis = _pin(
                jax.lax.dynamic_update_index_in_dim(basis, q, j, 0), 2
            )
        if reorth == "full":
            # residual-side pass: keeps the NEXT normalization's input
            # clean so the q-side cleanup above only has eps-level work
            valid = (karr <= j).astype(dtype)
            wn = _pin(block_cgs2(wn, basis, valid))
        elif reorth in ("periodic", "selective"):
            # residual-side pass whenever the cleanup fired: the q-side
            # cleanup alone discards the basis-overlap components of q
            # without their weight entering T, leaving an A V = V T + E
            # inconsistency of order overlap * ||beta|| accrued between
            # cleanups; subtracting the overlap from the residual (the
            # classic placement) removes it exactly (ADVICE r3)
            valid = (karr <= j).astype(dtype)
            wn = _pin(jax.lax.cond(
                do_clean,
                lambda w_: block_cgs2(w_, basis, valid),
                lambda w_: w_,
                wn,
            ))

        na_hist = jax.lax.dynamic_update_index_in_dim(
            na_hist, _fro(alpha), j, 0
        )
        nb_hist = jax.lax.dynamic_update_index_in_dim(
            nb_hist, _fro(beta), j, 0
        )
        new_carry = (q, wn, basis, om_prev, om, na_hist, nb_hist, force, dead)
        return new_carry, (alpha, beta, trace_at(q))

    carry0 = (
        q0, w, basis0,
        jnp.zeros((m,), dtype), omega0, na_hist0, nb_hist0,
        jnp.asarray(False), jnp.asarray(False),
    )
    if m > 1:
        carry, (alphas_r, betas_r, traces_r) = jax.lax.scan(
            body, carry0, jnp.arange(1, m)
        )
        basis_final = carry[2]
        w_final = carry[1]
        dead_final = carry[8]
        alphas = jnp.concatenate([alpha0[None], alphas_r])
        betas = jnp.concatenate([beta0[None], betas_r])
        trace = jnp.concatenate([trace_at(q0)[None], traces_r])
    else:
        basis_final = basis0
        w_final = w
        dead_final = jnp.asarray(False)
        alphas = alpha0[None]
        betas = beta0[None]
        trace = trace_at(q0)[None]

    # true beta_m of the completed factorization, from the residual block
    # left in the scan carry (only its norm enters the Ritz bounds).  The
    # qr path takes the TSQR R factor directly — never forms the Gram
    # matrix, whose squared condition number (and a possibly singular
    # residual after convergence) breaks the sqrtm backends.
    # A frozen run's residual is exactly zero (invariant subspace).
    if normalize == "qr":
        if dist_mesh is not None:
            _, beta_final = tsqr_sharded(
                w_final.reshape(p, -1), dist_mesh, axis=dist_axis
            )
        else:
            _, beta_final = tsqr(w_final.reshape(p, -1).T)
    else:
        beta_final, _ = sqrtm_inv(_gram(w_final, w_final))
    beta_final = jnp.where(dead_final, jnp.zeros_like(beta_final), beta_final)

    return BlockLanczosResult(
        alphas=alphas,
        betas=betas,
        trace=trace,
        basis=basis_final if store_basis else None,
        beta_final=beta_final,
        breakdown=dead_final,
    )
