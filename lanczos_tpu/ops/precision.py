"""Matmul precision policy for numerically critical contractions.

On the H100, JAX's DEFAULT precision runs a float32 matmul in TF32 (about
three decimal digits): a plain `jnp.einsum` Gram product or QR recombine
then carries a ~1e-3 relative error floor.  For a Lanczos library that is
fatal — basis orthogonality degrades to that level, the computed T drifts
off V^T A V, and Ritz values acquire 1e-3*||A|| errors with *tiny claimed
residual bounds* (measured: 2.5e-2 basis overlap and 0.4-absolute T errors
on a 20k-row SPD fixture before this policy was applied).

The reference is fp32 CUDA end to end (every kernel in
`source/kernels/*.hpp` accumulates in float), so full-f32 contractions
are also the parity-correct semantics.  The affected ops (p x n Gram and
update products, p x p small-eig rotations) are bandwidth- or
latency-bound at Lanczos block widths, so the FLOP-rate penalty of full
f32 does not move wall-clock.  Every on-card comparison against a
reference states its precision.

Elementwise paths (stencil, DIA, gathers, the Triton Gram kernel, which
accumulates with multiply-adds, not `dot`) never round through TF32.
"""

from __future__ import annotations

import jax

# use as: jnp.einsum(..., precision=HIGHEST) on every contraction whose
# result feeds orthogonality, T coefficients, or operator application.
HIGHEST = jax.lax.Precision.HIGHEST
