"""Headline benchmark: stencil SpMM nnz/s on the reference's largest fixture.

Reproduces the reference's hottest-kernel measurement (`ell::SpMM`,
`source/kernels/measurements/spmv_spmm.cu`: the N=160 Maxwell operator,
~24.6M rows, ELL width 4, block width N_COL=4, float32) with the
matrix-free stencil operator (`lanczos_tpu/models/maxwell.py`) that XLA
compiles, instead of a gathered ELL SpMM.

Baseline (BASELINE.md "spmm" table, N_COL=4): 24.6M rows in 6.17e-3 s
-> 4 nnz/row * 24.6M rows / 6.17e-3 s = 1.60e10 nnz/s on the Tesla T4.

Time per call: host clock around one application that ends in
`block_until_ready`, best of several after a compiling warm-up.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}.  Refuses to run
without a GPU.
"""

import json
import os

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.abspath(__file__))
REF_NNZ_PER_S = 4 * 24.6e6 * 4 / 6.17e-3  # BASELINE.md spmm, N_COL=4


def measure(n_grid: int = 160, p: int = 4) -> dict:
    """SpMM nnz/s of the Maxwell stencil at N=n_grid, block width p."""
    from lanczos_tpu.models.maxwell import MaxwellOperator
    from lanczos_tpu.utils.timing import steady

    op = MaxwellOperator.create(n_grid, n_grid, n_grid, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(0), (p, op.n), jnp.float32)
    secs = steady(jax.jit(lambda op, x: op.mm(x)), op, x, reps=10)
    # logical nnz of the assembled operator: ELL width 4 (2 curl blocks x
    # 2 taps per output row), matching the reference's flop model
    nnz_per_s = 4 * op.n * p / secs
    dev = jax.devices()[0]
    return {
        "metric": "maxwell_spmm_nnz_per_s",
        "value": nnz_per_s,
        "unit": "nnz/s (nnz x block-cols per second)",
        "vs_baseline": nnz_per_s / REF_NNZ_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }


def main():
    from lanczos_tpu.utils.compile_cache import use_checkout_cache
    from lanczos_tpu.utils.timing import card_line, require_gpu

    require_gpu("bench.py")
    use_checkout_cache(ROOT)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
