"""Global map: fixed-capacity point pool with cursor insert + periodic voxelize.

The reference accumulates transformed frame clouds into one growing
``pcl::PointCloud`` and periodically voxel-downsamples it (SURVEY.md §2.1
C12/C13, §3.5). A growing array fights XLA's static shapes (SURVEY.md §7
hard-part 4), so the map is a *fixed-capacity pool*:

- ``insert_cloud`` writes each frame's fixed-size masked cloud at a moving
  cursor (one ``dynamic_update_slice``, no data-dependent shapes);
- when the cursor nears capacity — or every ``downsample_every`` frames —
  ``downsample_map`` voxel-reduces the pool *in place* (sort + segment-sum,
  mapping/voxel.py), which also compacts survivors to the front and resets
  the cursor to the survivor count.

Eviction policy when even the voxelized pool overflows: newest points win
(the wrap drops the oldest slots), matching the online-survey use case.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.geometry.backproject import PointCloud
from online_3d_reconstruction.mapping.voxel import voxel_downsample


class GlobalMap(NamedTuple):
    points: jnp.ndarray   # (C, 3) float32 world coords
    colors: jnp.ndarray   # (C, 3) float32
    valid: jnp.ndarray    # (C,) bool
    cursor: jnp.ndarray   # () int32 — next insert offset


def create_map(capacity: int) -> GlobalMap:
    return GlobalMap(
        points=jnp.zeros((capacity, 3), dtype=jnp.float32),
        colors=jnp.zeros((capacity, 3), dtype=jnp.float32),
        valid=jnp.zeros((capacity,), dtype=bool),
        cursor=jnp.zeros((), dtype=jnp.int32),
    )


@jax.jit
def insert_cloud(gmap: GlobalMap, cloud: PointCloud) -> GlobalMap:
    """Append a fixed-size masked cloud at the cursor (wrapping at capacity)."""
    c = gmap.points.shape[0]
    n = cloud.points.shape[0]
    start = jnp.minimum(gmap.cursor, c - n)  # clamp: wrap handled by downsample
    points = jax.lax.dynamic_update_slice(gmap.points, cloud.points, (start, 0))
    colors = jax.lax.dynamic_update_slice(gmap.colors, cloud.colors, (start, 0))
    valid = jax.lax.dynamic_update_slice(gmap.valid, cloud.valid, (start,))
    return GlobalMap(points=points, colors=colors, valid=valid,
                     cursor=jnp.minimum(start + n, c))


@partial(jax.jit, static_argnames=("voxel_size", "bounds"), donate_argnums=(0,))
def downsample_map(gmap: GlobalMap, voxel_size: float,
                   bounds: float = 2048.0) -> GlobalMap:
    """Voxel-reduce + compact the pool; cursor moves to the survivor count."""
    reduced = voxel_downsample(
        PointCloud(points=gmap.points, colors=gmap.colors, valid=gmap.valid),
        voxel_size, bounds,
    )
    count = jnp.sum(reduced.valid).astype(jnp.int32)
    return GlobalMap(points=reduced.points, colors=reduced.colors,
                     valid=reduced.valid, cursor=count)


def needs_downsample(gmap: GlobalMap, frame_points: int) -> jnp.ndarray:
    """True when the next insert would hit the capacity clamp."""
    return gmap.cursor + frame_points >= gmap.points.shape[0]


@partial(jax.jit, static_argnames=("voxel_size", "bounds"),
         donate_argnums=(0, 1))
def flush_staging(gmap: GlobalMap, staging: GlobalMap, voxel_size: float,
                  bounds: float = 2048.0) -> Tuple[GlobalMap, GlobalMap]:
    """Voxelize the (small) staging pool and append its survivors to the
    main pool; returns (main', empty staging).

    Two-level compaction: per-frame clouds land in a staging pool sized for
    ``downsample_every`` frames, so the frequent voxel sort runs over ~1/5th
    of the points instead of the full map capacity (an LSM-style merge — the
    main pool is only re-voxelized when it approaches capacity). The main
    pool may transiently hold one point per (voxel, flush) pair; the final
    ``downsample_map`` merges those exactly.
    """
    reduced = voxel_downsample(
        PointCloud(points=staging.points, colors=staging.colors,
                   valid=staging.valid),
        voxel_size, bounds,
    )
    c = gmap.points.shape[0]
    s = staging.points.shape[0]
    start = jnp.minimum(gmap.cursor, c - s)
    survivors = jnp.sum(reduced.valid).astype(jnp.int32)
    new_main = GlobalMap(
        points=jax.lax.dynamic_update_slice(gmap.points, reduced.points,
                                            (start, 0)),
        colors=jax.lax.dynamic_update_slice(gmap.colors, reduced.colors,
                                            (start, 0)),
        valid=jax.lax.dynamic_update_slice(gmap.valid, reduced.valid,
                                           (start,)),
        cursor=start + survivors,
    )
    empty = GlobalMap(
        points=jnp.zeros_like(staging.points),
        colors=jnp.zeros_like(staging.colors),
        valid=jnp.zeros_like(staging.valid),
        cursor=jnp.zeros((), jnp.int32),
    )
    return new_main, empty


def map_to_numpy(gmap: GlobalMap) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the valid points/colors to host numpy (for export/IO)."""
    valid = np.asarray(gmap.valid)
    return np.asarray(gmap.points)[valid], np.asarray(gmap.colors)[valid]
