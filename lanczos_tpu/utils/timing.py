"""Timing on the accelerator, for the benchmark scripts and `chip_smoke.py`.

A time is the host clock around work that ends in `jax.block_until_ready`
(JAX returns before the device finishes, so without it a timing measures
the enqueue).  The first call of a shape compiles and is never counted.
Measurement scripts refuse to run without a GPU instead of timing the CPU.
"""

from __future__ import annotations

import subprocess
import sys
import time

import jax


def steady(fn, *args, reps: int = 3) -> float:
    """Best wall seconds of fn(*args) over `reps` calls after one warm-up
    call (which compiles)."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def per_iteration(run, m1: int, m2: int, reps: int = 3) -> float:
    """Seconds per iteration as the slope (t(m2) - t(m1)) / (m2 - m1) of
    run(m), which removes set-up, prologue and dispatch costs."""
    t1 = steady(lambda: run(m1), reps=reps)
    t2 = steady(lambda: run(m2), reps=reps)
    return (t2 - t1) / (m2 - m1)


def require_gpu(what: str) -> jax.Device:
    """The first device, or exit naming the missing GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"{what}: no GPU found (JAX platform is {dev.platform!r})")
    return dev


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them (a card
    below its maximum limit runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
