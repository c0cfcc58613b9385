"""lanczos_tpu — single-vector and block Lanczos framework in JAX.

A JAX/XLA implementation of the capabilities of the CUDA reference ``ibrohimmn1994/GPU-implementation-of-signle-and-block-Lanczos``
(see SURVEY.md): Lanczos tridiagonalization of large sparse symmetric
operators, used both for eigenvalue extraction (Ritz values) and to
approximate the action of a matrix exponential ``u(T) = expm(T*A) @ b``
at a receiver location, validated against an explicit forward-Euler FDTD
oracle on a 3-D staggered-grid Maxwell semi-discretization.

Design stance (a re-design, not a port), running on NVIDIA GPUs:
  * functional core: `lax.scan` recurrences, pytree matrix containers;
  * the Maxwell SpMV/SpMM as a matrix-free stencil that XLA fuses, beside
    gathered ELL / DIA / CSR / BSR containers for assembled matrices (the
    reference's `ell::SpMM`, `source/kernels/spmv_spmm.hpp`);
  * block-dense math (Gram products, tall x small updates) in XLA at
    precision HIGHEST, with the fused recurrence's multi-operand Gram as a
    Pallas kernel on the Triton route (the reference's `mm_tt`);
  * small-block sqrtm via an in-graph batched Jacobi eigensolver (replaces
    the warp-level Householder+QL kernel `source/kernels/my_sqrtm_cusolver.hpp`);
  * multi-card scaling via `jax.sharding.Mesh` + `shard_map` with psum /
    all_gather / ppermute collectives (the reference is single-GPU).
"""

from lanczos_tpu.version import __version__

# Lazy top-level API: `from lanczos_tpu import block_lanczos` etc. without
# importing jax (and triggering backend init) at package-import time.
_API = {
    "vector_lanczos": "lanczos_tpu.methods",
    "block_lanczos": "lanczos_tpu.methods",
    "lanczos_eigsh": "lanczos_tpu.methods",
    "block_lanczos_eigsh": "lanczos_tpu.methods",
    "lanczos_expm_action": "lanczos_tpu.methods",
    "block_lanczos_expm_action": "lanczos_tpu.methods",
    "fdtd_vector": "lanczos_tpu.methods",
    "fdtd_block": "lanczos_tpu.methods",
    "vector_lanczos_checkpointed": "lanczos_tpu.methods",
    "block_lanczos_checkpointed": "lanczos_tpu.methods",
    "fdtd_checkpointed": "lanczos_tpu.methods",
    "EllMatrix": "lanczos_tpu.ops.formats",
    "CsrMatrix": "lanczos_tpu.ops.formats",
    "CooMatrix": "lanczos_tpu.ops.formats",
    "BsrMatrix": "lanczos_tpu.ops.formats",
    "DiaMatrix": "lanczos_tpu.ops.formats",
    "ell_from_scipy": "lanczos_tpu.ops.formats",
    "csr_from_scipy": "lanczos_tpu.ops.formats",
    "coo_from_scipy": "lanczos_tpu.ops.formats",
    "bsr_from_scipy": "lanczos_tpu.ops.formats",
    "dia_from_scipy": "lanczos_tpu.ops.formats",
    "tsqr": "lanczos_tpu.ops.tsqr",
    "tsqr_sharded": "lanczos_tpu.ops.tsqr",
    "LinearOperator": "lanczos_tpu.ops.operator",
    "MaxwellOperator": "lanczos_tpu.models.maxwell",
    "StackedMaxwellOperator": "lanczos_tpu.models.maxwell_stacked",
    "DistributedStackedMaxwell": "lanczos_tpu.parallel",
    "halo_sharded_ell": "lanczos_tpu.parallel",
    "gather_sharded_ell": "lanczos_tpu.parallel",
    "make_mesh": "lanczos_tpu.parallel",
    "LanczosConfig": "lanczos_tpu.config",
    "load_sparse": "lanczos_tpu.io",
    "operator_from_file": "lanczos_tpu.io",
}

__all__ = ["__version__", *_API]


def __getattr__(name):
    if name in _API:
        import importlib

        return getattr(importlib.import_module(_API[name]), name)
    raise AttributeError(f"module 'lanczos_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
