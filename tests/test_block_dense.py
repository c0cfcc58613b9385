"""Block-dense products (`ops/block_dense.py`, the Triton-route Gram kernel
`ops/pallas/gram.py` in interpret mode) vs einsum oracles, and the fused
(traffic-minimal) block-Lanczos path vs the materialized recurrence.

Counterparts of the reference's mm_ts / mm_tt / mm_tt2 kernel A/B checks
(`kernels/measurements/mm_tt.cu:210-248` etc.).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lanczos_tpu.methods.block_lanczos import block_lanczos
from lanczos_tpu.ops.operator import MatrixOperator
from lanczos_tpu.ops.block_dense import block_grams, block_mix, gram_reference
from lanczos_tpu.ops.pallas.gram import triton_grams


@pytest.mark.parametrize(
    "state", [(6, 16, 256), (4096,), (3, 5, 16, 128)]
)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_block_mix_matches_einsum(rng, state, dtype):
    key = jax.random.PRNGKey(0)
    ps = [4, 4, 4]
    xs = [
        jnp.asarray(rng.standard_normal((p,) + state), dtype) for p in ps
    ]
    c = jnp.asarray(rng.standard_normal((sum(ps), 5)), dtype)
    out = block_mix(c, xs)
    ref = sum(
        jnp.einsum("kj,k...->j...", c[i * 4 : (i + 1) * 4], xs[i])
        for i in range(3)
    )
    tol = 1e-5 if dtype == jnp.float32 else 1e-12
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=tol, atol=tol
    )
    assert out.dtype == dtype


@pytest.mark.parametrize("state", [(6, 16, 256), (4096,)])
def test_block_grams_matches_einsum(rng, state):
    xs = [
        jnp.asarray(rng.standard_normal((p,) + state), jnp.float32)
        for p in (4, 6)
    ]
    z = jnp.asarray(rng.standard_normal((3,) + state), jnp.float32)
    g = block_grams(xs, z, include_zz=True)
    zf = np.asarray(z, np.float64).reshape(3, -1)
    ref = np.concatenate(
        [
            np.asarray(x, np.float64).reshape(x.shape[0], -1) @ zf.T
            for x in list(xs) + [z]
        ]
    )
    assert g.shape == (13, 3)
    np.testing.assert_allclose(np.asarray(g), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-12), (jnp.float32, 5e-5)])
def test_fused_matches_materialized(rng, dtype, tol):
    """block_lanczos auto-fused == fused=False on a generic symmetric
    operator, to rounding (exact in f64 up to O(eps) algebra shuffles)."""
    n, p, m = 640, 4, 9
    A = rng.standard_normal((n, n))
    A = jnp.asarray((A + A.T) / np.sqrt(n), dtype)
    b = jnp.asarray(rng.standard_normal((p, n)), dtype)
    op = MatrixOperator(A)
    r_std = block_lanczos(op, b, m, lc=3, fused=False)
    r_fus = block_lanczos(op, b, m, lc=3, fused=True)
    for name in ("alphas", "betas", "trace", "beta_final"):
        x = np.asarray(getattr(r_std, name))
        y = np.asarray(getattr(r_fus, name))
        scale = np.abs(x).max()
        np.testing.assert_allclose(y, x, rtol=0, atol=tol * scale, err_msg=name)


def test_fused_store_basis_and_breakdown(rng):
    """store_basis returns the full orthonormal basis; breakdown_tol
    freezes on an (approximately) invariant start block."""
    n, p, m = 320, 3, 6
    A = rng.standard_normal((n, n))
    A = jnp.asarray((A + A.T) / np.sqrt(n), jnp.float64)
    b = jnp.asarray(rng.standard_normal((p, n)), jnp.float64)
    op = MatrixOperator(A)
    r = block_lanczos(op, b, m, store_basis=True, fused=True)
    basis = np.asarray(r.basis).reshape(m * p, n)
    g = basis @ basis.T
    np.testing.assert_allclose(g, np.eye(m * p), atol=5e-7)

    # invariant subspace: b spans 3 exact eigenvectors -> freeze
    d = np.arange(1.0, n + 1)
    opd = MatrixOperator(jnp.asarray(np.diag(d)))
    be = np.zeros((p, n))
    be[0, 0] = be[1, 1] = be[2, 2] = 1.0
    rf = block_lanczos(
        opd, jnp.asarray(be), 4, breakdown_tol=1e-8, breakdown_eps=1e-10,
        fused=True,
    )
    assert bool(rf.breakdown)
    # frozen steps emit zero blocks
    assert float(jnp.abs(rf.alphas[-1]).max()) == 0.0
    assert float(jnp.abs(rf.beta_final).max()) == 0.0


def test_fused_trace_fn_maxwell(rng):
    """Fused path with the Maxwell stacked-state trace_fn override."""
    from lanczos_tpu.models.maxwell import MaxwellOperator
    from lanczos_tpu.models.rhs import gaussian_matrix_B

    op = MaxwellOperator.create(3, 3, 3, dtype=jnp.float64)
    b = jnp.asarray(np.asarray(gaussian_matrix_B(3, op.n, 3), np.float64))
    r0 = block_lanczos(op, b, 7, 11, fused=False)
    r1 = block_lanczos(op, b, 7, 11, fused=True)
    np.testing.assert_allclose(
        np.asarray(r1.trace), np.asarray(r0.trace), atol=1e-10
    )


def test_compensated_gram_f64_oracle(rng):
    """f64-accumulated Gram blocks from f32 storage reach O(eps_f32) of
    the f64 oracle on inputs whose plain-f32 accumulation error is ~10x
    larger (the reference's all-f64 block driver accuracy from f32
    storage, `test_lanczos.cu:349-356`)."""
    def block_grams_compensated(xs, z, include_zz=False):
        return block_grams(xs, z, include_zz, acc_dtype=jnp.float64)

    p, n = 4, 1 << 20
    x = (
        rng.standard_normal((p, n)) * np.exp(rng.uniform(-6, 6, (p, n)))
    ).astype(np.float32)
    z = (
        rng.standard_normal((p, n)) * np.exp(rng.uniform(-6, 6, (p, n)))
    ).astype(np.float32)
    exact = x.astype(np.float64) @ z.astype(np.float64).T
    g = np.asarray(
        block_grams_compensated((jnp.asarray(x),), jnp.asarray(z))
    )[:p]
    scale = np.abs(exact).max()
    assert np.abs(g - exact).max() / scale < 5e-7  # ~4 eps_f32

    gz = np.asarray(
        block_grams_compensated(
            (jnp.asarray(x),), jnp.asarray(z), include_zz=True
        )
    )
    exact_zz = z.astype(np.float64) @ z.astype(np.float64).T
    assert (
        np.abs(gz[p:] - exact_zz).max() / np.abs(exact_zz).max() < 5e-7
    )


def test_compensated_block_lanczos_t_coefficients(rng):
    """fused + compensated=True from f32 storage tracks the f64 oracle
    recurrence's T coefficients more closely than the plain-f32 path."""
    n, p, m = 2048, 4, 6
    A = rng.standard_normal((n, n))
    A = (A + A.T) / np.sqrt(n)
    b = rng.standard_normal((p, n))
    # f64 oracle
    op64 = MatrixOperator(jnp.asarray(A))
    r64 = block_lanczos(op64, jnp.asarray(b), m, fused=False)
    op32 = MatrixOperator(jnp.asarray(A, jnp.float32))
    b32 = jnp.asarray(b, jnp.float32)
    r32c = block_lanczos(op32, b32, m, compensated=True)
    r32p = block_lanczos(op32, b32, m, fused=True)
    a64 = np.asarray(r64.alphas)
    err_c = np.abs(np.asarray(r32c.alphas) - a64).max()
    err_p = np.abs(np.asarray(r32p.alphas) - a64).max()
    # both are f32-storage-limited at later steps, but the compensated
    # first-step coefficients must be at f32-representation level
    a0_err_c = np.abs(np.asarray(r32c.alphas[0]) - a64[0]).max()
    assert a0_err_c < 5e-6 * np.abs(a64[0]).max()
    assert err_c <= err_p * 1.5  # never meaningfully worse overall


@pytest.mark.parametrize("m", [1, 2, 3])
def test_fused_small_m_edges(rng, m):
    """m=1 (prologue only), m=2 (peeled step, no scan), m=3 (scan length
    1) all match the materialized recurrence — the fused path's peeled
    structure makes these genuinely different code paths."""
    n, p = 320, 4
    A = rng.standard_normal((n, n))
    A = jnp.asarray((A + A.T) / np.sqrt(n), jnp.float64)
    b = jnp.asarray(rng.standard_normal((p, n)), jnp.float64)
    op = MatrixOperator(A)
    r0 = block_lanczos(op, b, m, lc=5, fused=False)
    r1 = block_lanczos(op, b, m, lc=5, fused=True)
    for name in ("alphas", "betas", "trace", "beta_final"):
        np.testing.assert_allclose(
            np.asarray(getattr(r1, name)), np.asarray(getattr(r0, name)),
            atol=1e-11, err_msg=f"m={m} {name}",
        )


def test_vector_fused_route_matches_classic(rng):
    """vector_lanczos fused=True (the p=1 fused route with the scalar
    sqrt fast path) == the classic scan, including beta_final and basis."""
    from lanczos_tpu.methods.vector_lanczos import vector_lanczos

    n, m = 512, 10
    A = rng.standard_normal((n, n))
    A = jnp.asarray((A + A.T) / np.sqrt(n), jnp.float64)
    b = jnp.asarray(rng.standard_normal(n), jnp.float64)
    op = MatrixOperator(A)
    r0 = vector_lanczos(op, b, m, lc=7, fused=False, store_basis=True)
    r1 = vector_lanczos(op, b, m, lc=7, fused=True, store_basis=True)
    for name in ("alphas", "betas", "trace", "beta_final", "basis"):
        np.testing.assert_allclose(
            np.asarray(getattr(r1, name)), np.asarray(getattr(r0, name)),
            atol=1e-11, err_msg=name,
        )


_GRAM_CASES = [
    (p, n, k, acc)
    for p in (1, 2, 4, 8, 16)
    for n in (1000, 2048)  # ragged, and a multiple of every row tile
    for k in (1, 2, 3)
    for acc in ("float32", "float64")
]


@pytest.mark.parametrize("p,n,k,acc", _GRAM_CASES)
def test_triton_grams_interpret(rng, p, n, k, acc):
    """The Triton-route Gram kernel (interpret mode) against the jnp
    reference at precision HIGHEST: k operands of mixed widths against
    one z, with gram(z, z), accumulated in f32 or f64."""
    widths = [p, max(p // 2, 1), p + 1][:k]
    xs = [jnp.asarray(rng.standard_normal((w, n)), jnp.float32)
          for w in widths]
    z = jnp.asarray(rng.standard_normal((p, n)), jnp.float32)
    got = triton_grams(xs, z, include_zz=True, acc_dtype=acc,
                       interpret=True)
    ref = gram_reference(xs, z, include_zz=True, acc_dtype=acc)
    assert got.shape == (sum(widths) + p, p) and got.dtype == ref.dtype
    # f32: ~sqrt(n) eps accumulation-order noise; f64: rounding of the
    # f32 products is exact in f64, so only f64 summation order differs
    tol = 1e-5 if acc == "float32" else 1e-12
    scale = float(jnp.abs(ref).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=tol * scale)


def test_triton_grams_state_shapes(rng):
    """Structured (p, *state) operands are read as their flat rows."""
    xs = [jnp.asarray(rng.standard_normal((3, 6, 5, 7)), jnp.float32)]
    z = jnp.asarray(rng.standard_normal((3, 6, 5, 7)), jnp.float32)
    got = triton_grams(xs, z, include_zz=False, interpret=True)
    ref = gram_reference(xs, z)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)


def test_block_grams_platform_choice(rng, monkeypatch):
    """gpu runs the kernel, cpu the plain jnp version, any other platform
    raises."""
    import lanczos_tpu.ops.block_dense as bd
    import lanczos_tpu.ops.pallas.gram as gram_mod

    z = jnp.asarray(rng.standard_normal((2, 64)), jnp.float32)
    calls = []
    monkeypatch.setattr(
        gram_mod, "triton_grams",
        lambda *a, **k: calls.append(k) or gram_reference(a[0], a[1]),
    )
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    bd.block_grams((z,), z)
    assert calls and "interpret" not in calls[0]
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(NotImplementedError):
        bd.block_grams((z,), z)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    np.testing.assert_allclose(
        np.asarray(bd.block_grams((z,), z, include_zz=True)),
        np.asarray(gram_reference((z,), z, include_zz=True)),
    )


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_triton_grams_on_card(gpu, p):
    """The kernel compiled for the card (no interpret mode) against the
    jnp reference at HIGHEST, at a ragged width of a few tiles."""
    kx, kz = jax.random.split(jax.random.PRNGKey(p))
    n = 3 * 4096 + 17
    xs = (jax.random.normal(kx, (p, n), jnp.float32),)
    z = jax.random.normal(kz, (p, n), jnp.float32)
    got = np.asarray(triton_grams(xs, z, include_zz=True))
    ref = np.asarray(gram_reference(xs, z, include_zz=True))
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


class _RoutedToFused(Exception):
    pass


@pytest.mark.parametrize("p,n,fused", [
    (1, 1 << 20, False), (1, 1 << 22, True),  # 4 MiB / 16 MiB vectors
    (2, 1 << 16, False), (2, 1 << 17, True),  # 0.5 MiB / 1 MiB blocks
])
def test_fused_gate_by_width(monkeypatch, p, n, fused):
    """Bare runs take the fused recurrence from 16 MiB at p=1 and from
    1 MiB at p >= 2 (the crossovers measured on the card)."""
    import scipy.sparse as sp

    import lanczos_tpu.methods.block_lanczos_fused as blf
    from lanczos_tpu.methods.vector_lanczos import vector_lanczos
    from lanczos_tpu.ops.formats import dia_from_scipy

    def spy(*args, **kwargs):
        raise _RoutedToFused

    monkeypatch.setattr(blf, "block_lanczos_fused", spy)
    op = dia_from_scipy(sp.diags(np.linspace(1.0, 2.0, n)), dtype=jnp.float32)
    b = jnp.ones((p, n), jnp.float32)
    if p == 1:
        run = lambda: vector_lanczos(op, b[0], 2)
    else:
        run = lambda: block_lanczos(op, b, 2)
    if fused:
        with pytest.raises(_RoutedToFused):
            run()
    else:
        jax.block_until_ready(run().alphas)
