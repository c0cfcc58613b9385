"""Multi-chip layer: device meshes and row-sharded operators.

The reference has no distributed backend (SURVEY.md §2); this package is
the north-star addition — `shard_map` SpMV with `ppermute` halo exchange,
`all_gather` fallback, and GSPMD-inserted `psum` for every reduction in
the Lanczos recurrences.
"""

from lanczos_tpu.parallel.mesh import ROWS_AXIS, make_mesh, replicated, row_sharding
from lanczos_tpu.parallel.dist_operator import (
    GatherShardedEll,
    HaloShardedEll,
    gather_sharded_ell,
    halo_sharded_ell,
)
from lanczos_tpu.parallel.dist_stencil import DistributedStackedMaxwell

__all__ = [
    "ROWS_AXIS",
    "make_mesh",
    "replicated",
    "row_sharding",
    "GatherShardedEll",
    "HaloShardedEll",
    "gather_sharded_ell",
    "halo_sharded_ell",
    "DistributedStackedMaxwell",
]
