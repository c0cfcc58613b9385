"""The fused (traffic-minimal) recurrence and compensated (float64)
Gram accumulation.

Run on CPU:   JAX_PLATFORMS=cpu python examples/fused_and_compensated.py
Run on a GPU: python examples/fused_and_compensated.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)  # compensated=True accumulates in f64

import jax.numpy as jnp
import numpy as np

from lanczos_tpu.methods.block_lanczos import block_lanczos
from lanczos_tpu.methods.eigs import block_lanczos_eigsh
from lanczos_tpu.ops.operator import MatrixOperator

rng = np.random.default_rng(0)
n, p, m = 4096, 4, 16
A = rng.standard_normal((n, n))
A = (A + A.T) / np.sqrt(n)
op32 = MatrixOperator(jnp.asarray(A, jnp.float32))
b32 = jnp.asarray(rng.standard_normal((p, n)), jnp.float32)

# 1. Bare (no-reorth) runs on big states auto-route through the fused
#    recurrence (3 state passes / iteration; the residual block is never
#    materialized).  fused=True forces it at any size; fused=False forces
#    the reference-semantics materialized scan.
r_fused = block_lanczos(op32, b32, m, fused=True)
r_classic = block_lanczos(op32, b32, m, fused=False)
print(
    "fused vs materialized: max |Δalpha| =",
    float(jnp.max(jnp.abs(r_fused.alphas - r_classic.alphas))),
)

# 2. compensated=True accumulates every Gram in float64 from the f32
#    states: T coefficients at ~eps_f32 of the f64 oracle — the
#    reference's all-double block driver accuracy from f32 storage.
r_comp = block_lanczos(op32, b32, m, compensated=True)
print("compensated alphas[0][0,0]:", float(r_comp.alphas[0][0, 0]))

# 3. Both knobs thread through the eigsh front end.
vals, _, resid = block_lanczos_eigsh(
    op32, b32, m=24, k=4, which="LA", reorth="none", fused=True
)
dense = np.linalg.eigvalsh(A)[-4:][::-1]
print("top-4 Ritz:", np.asarray(vals).round(5))
print("dense     :", dense.round(5))
# the dense-spectrum GOE edge needs more iterations to converge fully;
# the printed residual BOUNDS honestly cover the remaining error
print("residual bounds:", np.asarray(resid).round(6))
