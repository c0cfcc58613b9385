"""Matrix-exponential action on the 3-D Maxwell operator — the
reference's headline pipeline (`test_lanczos.cu`), on the stacked
folded-plane state with an FDTD oracle check.

    python examples/expm_maxwell.py [N]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

import lanczos_tpu as lt
from lanczos_tpu.methods.fdtd import fdtd_block
from lanczos_tpu.models.rhs import gaussian_matrix_B


def main(n_grid: int = 10):
    op = lt.StackedMaxwellOperator.create(n_grid, n_grid, n_grid)
    p, m, lc = 4, 8, 30
    B = op.pack(jnp.asarray(np.asarray(
        gaussian_matrix_B(n_grid, op.n, p), np.float32)))

    sol = lt.block_lanczos_expm_action(
        op, B, m, 1.0, 0, trace_fn=op.trace_fn(lc)
    )
    print(f"[expm(A) B]_{lc} via {m}-step block Lanczos:", np.asarray(sol))

    u = fdtd_block(op, B, 100_000, 1.0)
    ref = np.asarray(op.unpack(u))[:, lc]
    rel = np.linalg.norm(np.asarray(sol) - ref) / np.linalg.norm(ref)
    print("FDTD oracle       :", ref)
    print("relative error    :", float(rel))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10)
