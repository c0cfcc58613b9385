"""Run configuration (SURVEY.md §5 "Config / flag system").

The reference's knobs are compile-time macros (N_COL, USE_BLAS) plus two
CLI flags with a broken help text (`test_lanczos.cu:338-345`, `-blas`
ignored, `use_block` hard-coded).  Here everything is a runtime dataclass
consumed by the CLI driver and usable programmatically.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LanczosConfig:
    # problem
    n_grid: int = 10          # reference -N (Maxwell grid size)
    m: int = 5                # reference -m (Lanczos iterations)
    block: bool = True        # block vs single-vector (use_block)
    n_col: int = 4            # block width (reference N_COL macro)
    t_end: float = 1.0
    fdtd_steps: int = 1_000_000
    lc: int | None = None     # receiver index; None -> randomized 1..100
    seed: int = 0

    # numerics
    dtype: str = "float32"
    reorth: str = "none"      # none | full | selective (vector) / periodic
    eig_backend: str = "jacobi"  # in-scan small eigensolver
    eig_sweeps: int | None = None  # None = backend default (jacobi 10, newton 18)
    breakdown_tol: float = 0.0
    normalize: str = "sqrtm"  # sqrtm (reference) | qr (TSQR, rank-safe)
    breakdown_eps: float = 0.0  # rank-revealing deflation threshold
    replace_dead: bool = False  # adaptive restart of collapsed directions
    fused: bool | None = None   # None=auto: traffic-minimal fused recurrence
    compensated: bool = False   # float64 Gram accumulation (fused path)

    # execution
    operator: str = "stencil"  # stencil | stacked | ell
    devices: int = 1           # >1: z-sharded distributed stacked operator
    validate: bool = True      # run the FDTD oracle comparison
    profile_dir: str | None = None  # capture a jax.profiler trace here
