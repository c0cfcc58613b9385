"""Test configuration: run everything on a virtual 8-device CPU mesh.

The tests run on the CPU; `shard_map` collectives are validated on XLA's
host platform with 8 virtual devices (SURVEY.md §4d).  x64 is enabled so
fp64 oracle paths (BASELINE config 1) are exact.  jax.config.update takes
effect as long as no backend is initialized.

Tests that need a GPU carry the `gpu` marker and ask for the `gpu`
fixture, which skips them here; run them on the card with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests -o addopts= -m gpu`.
"""

import os

import jax

# cpu unless the caller names the platforms (the `gpu` tests on the card)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first device, for tests marked `gpu`; skips without a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
