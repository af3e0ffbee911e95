"""Voxel-grid downsampling as sort-by-key + segment reduction.

The reference periodically runs ``pcl::VoxelGrid<PointXYZRGB>`` over the
global cloud: one centroid-averaged point (position and color) per occupied
leaf (SURVEY.md §2.1 C13, §3.5). North star mandate: "PCL voxel filter ->
sorted-segment scatter reduction".

Design: quantize to integer voxel coords, build a two-word key
(the full 3D index exceeds int32, so we sort lexicographically by (low, high)
with two stable sorts), mark segment boundaries where either word changes,
turn boundaries into dense segment ids with a cumsum, and centroid-average
via ``segment_sum``. Output is compacted by construction (segment ids are
dense), same static capacity in as out, invalid slots masked — the streaming
form the global map consumes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from online_3d_reconstruction.geometry.backproject import PointCloud

_SENTINEL = jnp.int32(2**31 - 1)


def voxel_coords(points: jnp.ndarray, voxel_size: float, bounds: float) -> jnp.ndarray:
    """(N, 3) int32 voxel indices; caller guarantees |coord| < bounds."""
    return jnp.floor((points + bounds) / voxel_size).astype(jnp.int32)


@partial(jax.jit, static_argnames=("voxel_size", "bounds"))
def voxel_downsample(cloud: PointCloud, voxel_size: float,
                     bounds: float = 2048.0) -> PointCloud:
    """One centroid point per occupied voxel (pcl::VoxelGrid semantics).

    Same capacity out as in; representatives occupy the leading slots
    (compacted), trailing slots are invalid.
    """
    n = cloud.points.shape[0]
    per_axis = int(2.0 * bounds / voxel_size) + 2
    if per_axis * per_axis >= 2**31:
        raise ValueError("voxel grid too fine for two-word keys; raise voxel_size")

    idx = voxel_coords(cloud.points, voxel_size, bounds)
    in_bounds = jnp.all((idx >= 0) & (idx < per_axis), axis=1) & cloud.valid
    # two-word lexicographic key: hi = ix, lo = iy * nz + iz
    key_hi = jnp.where(in_bounds, idx[:, 0], _SENTINEL)
    key_lo = jnp.where(in_bounds, idx[:, 1] * per_axis + idx[:, 2], _SENTINEL)

    # ONE multi-operand lexicographic sort carrying the payload columns:
    # argsort + per-column gathers would re-permute the pool with 5 gathers
    # (~10x the cost of the fused sort on the earlier accelerator target;
    # not yet measured on the H100)
    (hi_s, lo_s, px, py, pz, cr, cg, cb, val_s) = jax.lax.sort(
        (key_hi, key_lo,
         cloud.points[:, 0], cloud.points[:, 1], cloud.points[:, 2],
         cloud.colors[:, 0], cloud.colors[:, 1], cloud.colors[:, 2],
         in_bounds),
        num_keys=2,
    )
    pts_s = jnp.stack([px, py, pz], axis=1)
    col_s = jnp.stack([cr, cg, cb], axis=1)

    new_seg = jnp.concatenate(
        [
            jnp.ones((1,), dtype=jnp.int32),
            ((hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])).astype(jnp.int32),
        ]
    )
    seg_id = jnp.cumsum(new_seg) - 1  # dense ids, 0-based, ASCENDING

    valf = val_s.astype(jnp.float32)[:, None]
    sum_pts = jax.ops.segment_sum(pts_s * valf, seg_id, num_segments=n,
                                  indices_are_sorted=True)
    sum_col = jax.ops.segment_sum(col_s * valf, seg_id, num_segments=n,
                                  indices_are_sorted=True)
    counts = jax.ops.segment_sum(valf[:, 0], seg_id, num_segments=n,
                                 indices_are_sorted=True)
    denom = jnp.maximum(counts, 1.0)[:, None]

    # a segment is a real voxel iff its first element was in-bounds/valid
    seg_valid = jax.ops.segment_max(val_s.astype(jnp.int32), seg_id,
                                    num_segments=n, indices_are_sorted=True) > 0
    return PointCloud(
        points=sum_pts / denom,
        colors=sum_col / denom,
        valid=seg_valid,
    )
