"""Hand-written GPU kernels (Pallas, Triton route).

Each kernel stays only while it beats what XLA compiles from the plain
jnp version on the card; `PERF.md` keeps both numbers.
"""
