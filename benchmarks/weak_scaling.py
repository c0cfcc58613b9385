"""Weak-scaling harness for the z-sharded Maxwell operator (BASELINE.md
">=80% weak-scaling efficiency"; one host of up to four NVLink cards).

Holds the per-device problem size FIXED (a z-slab of `--z-per-device`
planes) while growing the mesh, and reports per-SpMM time and the
efficiency t(1)/t(d).  Communication per step is one `ppermute`d z-plane
per neighbor — O(plane), independent of the per-device volume — so ideal
weak scaling is flat.  Times are the host clock around `block_until_ready`.

Usage:
    python benchmarks/weak_scaling.py --devices 1 2 4 --n-xy 160
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def weak_scaling(sizes, n_xy: int, z_per_device: int, p: int) -> list[dict]:
    """One row per mesh size d: SpMM seconds at nz = z_per_device * d."""
    from lanczos_tpu.parallel import DistributedStackedMaxwell, make_mesh
    from lanczos_tpu.utils.timing import steady

    rows, t1 = [], None
    for d in sizes:
        mesh = make_mesh(d)
        nz = z_per_device * d  # FIXED volume per device
        op = DistributedStackedMaxwell.create(n_xy, n_xy, nz, mesh,
                                              dtype=jnp.float32)
        u = op.pack(np.random.default_rng(0)
                    .standard_normal((p, op.n)).astype(np.float32))
        sec = steady(jax.jit(lambda a, y: a.mm(y)), op, u)
        t1 = sec if t1 is None else t1
        rows.append({
            "devices": d, "n": op.n, "nz": nz, "p": p,
            "seconds_per_spmm": sec, "efficiency": t1 / sec,
            "nnz_per_s_total": 4 * op.n * p / sec,
        })
        print("  ".join(f"{k}={v:.4g}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in rows[-1].items()), flush=True)
    return rows


def main():
    from lanczos_tpu.utils.compile_cache import use_checkout_cache
    from lanczos_tpu.utils.timing import card_line, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="mesh sizes to test (default: 1..device_count pow2)")
    ap.add_argument("--n-xy", type=int, default=160,
                    help="x/y grid extent (plane size)")
    ap.add_argument("--z-per-device", type=int, default=40,
                    help="interior z planes per device (weak scaling)")
    ap.add_argument("--p", type=int, default=4, help="block columns")
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args()
    require_gpu("weak_scaling")
    use_checkout_cache()
    print(f"card: {card_line()}", flush=True)
    avail = jax.device_count()
    sizes = args.devices or [d for d in (1, 2, 4) if d <= avail]
    rows = weak_scaling(sizes, args.n_xy, args.z_per_device, args.p)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
