"""Persistent compilation cache location for the entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing here
overrides it.  Otherwise the cache lives at ``<checkout>/.jax_cache``: a
fixed path, since the path is part of what makes a cached entry hit.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def use_checkout_cache(root: str = CHECKOUT) -> str:
    """Point JAX's persistent compilation cache at `root`/.jax_cache unless
    JAX_COMPILATION_CACHE_DIR is set.  Returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
