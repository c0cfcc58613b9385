"""Linear-operator protocol for the Lanczos methods.

The reference hard-wires its algorithms to one container (`Ell_matrix`,
reference `source/objects/ell_matrix.hpp`).  Here every Lanczos/FDTD method
takes any object implementing this protocol, so the same `lax.scan`
recurrence runs over ELL/CSR/COO/BSR matrices, the matrix-free Maxwell
stencil operator, or a sharded distributed operator.
"""

from __future__ import annotations

import abc
from typing import Any

import jax
import jax.numpy as jnp

from lanczos_tpu.ops.precision import HIGHEST


class LinearOperator(abc.ABC):
    """A symmetric linear operator y = A @ x usable inside jit/scan.

    Implementations must be pytrees (registered via
    ``jax.tree_util.register_pytree_node``) so they can be closed over or
    passed through ``jax.jit`` / ``lax.scan`` without host sync.
    """

    @property
    @abc.abstractmethod
    def shape(self) -> tuple[int, int]:
        ...

    @property
    @abc.abstractmethod
    def dtype(self) -> Any:
        ...

    @abc.abstractmethod
    def mv(self, x: jax.Array) -> jax.Array:
        """Matrix-vector product on a state (an (n,) vector for matrix
        formats; operators may use richer state shapes, e.g. the Maxwell
        stencil's stacked field layout)."""

    def mm(self, X: jax.Array) -> jax.Array:
        """Block product, BLOCK-MAJOR: X: (p, *state_shape) -> same.

        The block axis leads (each block column is one contiguous
        state), unlike the reference's column-major tall
        matrices (`dense_matrix.hpp:11`).  Default: vmap of mv over the
        leading axis; formats override with a fused SpMM (the reference's
        hottest kernel, `spmv_spmm.hpp:138`).
        """
        return jax.vmap(self.mv)(X)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    def __matmul__(self, x: jax.Array) -> jax.Array:
        if x.ndim == 1:
            return self.mv(x)
        return self.mm(x)


@jax.tree_util.register_pytree_node_class
class MatrixOperator(LinearOperator):
    """Dense-matrix operator (testing / small oracles)."""

    def __init__(self, a: jax.Array):
        self.a = a

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    def mv(self, x):
        return jnp.matmul(self.a, x, precision=HIGHEST)

    def mm(self, X):
        # X block-major (p, n): (A X^T)^T = X A^T
        return jnp.matmul(X, self.a.T, precision=HIGHEST)

    def tree_flatten(self):
        return (self.a,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

def state_trace(q, lc_idx, block: bool):
    """Receiver extraction q[..., lc] WITHOUT flattening the state.

    `q.reshape(p, -1)` on a structured (tiled) state is a full relayout
    copy — measured 2.6 ms on the 450 MB Maxwell block state, i.e. more
    than the Gram product it sits next to.  Unraveling lc into the native
    state shape and taking a dynamic_slice reads one element per block
    column instead.  block=True treats axis 0 as the block axis."""
    state_shape = q.shape[1:] if block else q.shape
    if len(state_shape) == 1:
        qf = q if not block else q
        return jax.lax.dynamic_index_in_dim(
            qf, lc_idx, axis=1 if block else 0, keepdims=False
        )
    idx = jnp.unravel_index(lc_idx, state_shape)
    starts = tuple(jnp.asarray(i, jnp.int32) for i in idx)
    if block:
        p = q.shape[0]
        sl = jax.lax.dynamic_slice(
            q, (jnp.int32(0),) + starts, (p,) + (1,) * len(state_shape)
        )
        return sl.reshape(p)
    sl = jax.lax.dynamic_slice(q, starts, (1,) * len(state_shape))
    return sl.reshape(())
