"""Distributed block Lanczos on a device mesh.

Works on any mesh JAX exposes (the cards of one host); to simulate 8
devices on the CPU:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/distributed_lanczos.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import lanczos_tpu as lt
from lanczos_tpu.models.rhs import gaussian_matrix_B


def main():
    mesh = lt.make_mesh(jax.device_count())
    print(f"mesh: {mesh.shape}")

    # z-slab-sharded stacked Maxwell operator; one ppermute'd halo plane
    # per neighbor per SpMM, psum-reduced Gram matrices (GSPMD).
    op = lt.DistributedStackedMaxwell.create(8, 8, 8, mesh)
    B = op.pack(np.asarray(gaussian_matrix_B(8, op.n, 4), np.float32))
    vals, _, resid = lt.block_lanczos_eigsh(op, B, m=10, k=3, which="LM")
    print("top-3 |Ritz| :", np.asarray(vals))
    print("residuals    :", np.asarray(resid))


if __name__ == "__main__":
    main()
