"""Forward-Euler FDTD ground-truth integrators (reference `methods/fdtd.hpp`).

u(T_end) integrated as u += dt * A u for Nsteps; the physics oracle the
reference validates Lanczos-expm against (test_lanczos.cu:118-123, :294-301).
Implemented as `lax.fori_loop` so the million-step run stays on device;
XLA fuses the axpy into the operator application.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from lanczos_tpu.ops.operator import LinearOperator


@partial(jax.jit, static_argnames=("nsteps",))
def fdtd_vector(
    a: LinearOperator, u0: jax.Array, nsteps: int, t_end: float
) -> jax.Array:
    """Returns u(T_end) (full vector; index with lc at the call site)."""
    dt = jnp.asarray(t_end / nsteps, u0.dtype)

    def step(_, u):
        return u + dt * a.mv(u)

    return jax.lax.fori_loop(0, nsteps, step, u0)


@partial(jax.jit, static_argnames=("nsteps",))
def fdtd_block(
    a: LinearOperator, u0: jax.Array, nsteps: int, t_end: float
) -> jax.Array:
    """Block version (reference `ftdt_block`, fdtd.hpp:34): U += dt * A U.
    U is BLOCK-MAJOR (p, n)."""
    dt = jnp.asarray(t_end / nsteps, u0.dtype)

    def step(_, u):
        return u + dt * a.mm(u)

    return jax.lax.fori_loop(0, nsteps, step, u0)
