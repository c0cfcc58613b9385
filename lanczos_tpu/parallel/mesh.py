"""Device-mesh helpers for the distributed layer.

The reference is strictly single-GPU (SURVEY.md §2 "Parallelism &
communication inventory": no MPI/NCCL/streams).  This framework adds the
multi-card dimension: a 1-D mesh over the ``rows`` axis — domain
decomposition of the operator rows and every Krylov vector — with
`shard_map` collectives (`ppermute` halo exchange, `psum` reductions).
The cards of one host are joined all to all by NVLink, so the mesh follows
the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS_AXIS = "rows"


def make_mesh(n_devices: int | None = None, axis: str = ROWS_AXIS) -> Mesh:
    """1-D mesh over the first `n_devices` (default: all) devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(
            f"requested {n_devices} devices, only {len(devs)} available"
        )
    return Mesh(np.asarray(devs[:n_devices]), (axis,))


def row_sharding(mesh: Mesh, axis: str = ROWS_AXIS) -> NamedSharding:
    """Shard the leading (row) dimension; replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
