"""Point-sharded voxel reduction (P3): distributed map downsampling.

The reference's PCL voxel filter is single-machine; the global map
shards its point pool across devices. Downsampling then runs in two stages
(SURVEY.md §2.3 P3):

1. local: each device sort+segment-reduces its own point shard
   (mapping/voxel.py) — removes intra-shard duplicates;
2. merge: the compacted survivors are all-gathered (they are far smaller
   than the raw pool after stage 1) and reduced once more, replicated.

Exactness: centroid-of-centroids is not centroid-of-points, so stage 1
carries per-voxel *sums and counts* rather than means; stage 2 finishes the
division. Result is bit-comparable (up to fp reduction order) to the
single-device filter — asserted on the CPU-simulated mesh in
tests/test_parallel.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from online_3d_reconstruction.geometry.backproject import PointCloud
from online_3d_reconstruction.mapping.voxel import _SENTINEL, voxel_coords


def _local_reduce(points, colors, valid, voxel_size, bounds, per_axis):
    """Segment-reduce a shard, carrying (sum, count) instead of means."""
    n = points.shape[0]
    idx = voxel_coords(points, voxel_size, bounds)
    in_bounds = jnp.all((idx >= 0) & (idx < per_axis), axis=1) & valid
    key_hi = jnp.where(in_bounds, idx[:, 0], _SENTINEL)
    key_lo = jnp.where(in_bounds, idx[:, 1] * per_axis + idx[:, 2], _SENTINEL)

    order = jnp.argsort(key_lo, stable=True)
    order = order[jnp.argsort(key_hi[order], stable=True)]
    hi_s, lo_s = key_hi[order], key_lo[order]
    pts_s, col_s, val_s = points[order], colors[order], in_bounds[order]

    new_seg = jnp.concatenate(
        [jnp.ones((1,), jnp.int32),
         ((hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])).astype(jnp.int32)]
    )
    seg_id = jnp.cumsum(new_seg) - 1
    valf = val_s.astype(jnp.float32)[:, None]
    sum_pts = jax.ops.segment_sum(pts_s * valf, seg_id, num_segments=n)
    sum_col = jax.ops.segment_sum(col_s * valf, seg_id, num_segments=n)
    counts = jax.ops.segment_sum(valf[:, 0], seg_id, num_segments=n)
    # representative keys per segment (first element of each segment)
    rep_hi = jax.ops.segment_min(hi_s, seg_id, num_segments=n)
    rep_lo = jax.ops.segment_min(lo_s, seg_id, num_segments=n)
    return sum_pts, sum_col, counts, rep_hi, rep_lo


def _merge_records(rec: jnp.ndarray, hi: jnp.ndarray, lo: jnp.ndarray):
    """Sum (M, C) records sharing a (hi, lo) voxel key. Returns
    (tot (M, C), rep_hi (M,), rep_lo (M,)) with segment results compacted at
    the front (segment ids are a prefix)."""
    m = rec.shape[0]
    order = jnp.argsort(lo, stable=True)
    order = order[jnp.argsort(hi[order], stable=True)]
    hi_s, lo_s, rec_s = hi[order], lo[order], rec[order]
    new_seg = jnp.concatenate(
        [jnp.ones((1,), jnp.int32),
         ((hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])).astype(jnp.int32)]
    )
    seg_id = jnp.cumsum(new_seg) - 1
    tot = jax.ops.segment_sum(rec_s, seg_id, num_segments=m)
    rep_hi = jax.ops.segment_min(hi_s, seg_id, num_segments=m)
    rep_lo = jax.ops.segment_min(lo_s, seg_id, num_segments=m)
    return tot, rep_hi, rep_lo


@partial(jax.jit, static_argnames=("voxel_size", "bounds", "mesh", "bucket_capacity"))
def voxel_route_merge(points: jnp.ndarray, colors: jnp.ndarray,
                      valid: jnp.ndarray, mesh: Mesh, voxel_size: float,
                      bounds: float = 2048.0,
                      bucket_capacity: int = 0):
    """Owner-routed voxel merge: the streaming voxel-merge over NVLink (P3).

    Three stages per device:

    1. LOCAL pre-reduction: sort+segment-reduce the own shard once,
       producing at most one (sum, count, key) record per locally-occupied
       voxel — the only O(N/n log N/n) sort over raw points.
    2. Route: each record's voxel key hashes to one owner device; records
       pack into fixed-capacity per-destination buckets and one
       ``all_to_all`` ships them between devices. Shipping pre-reduced records
       instead of raw points cuts both wire bytes and the owner's work by
       the local duplication factor (large for a fused map pool).
    3. Owner merge: sum the received records BY KEY (sum-of-sums — exact,
       no centroid-of-centroids) and divide.

    With an explicit ``bucket_capacity`` c the per-shard post-route work is
    O(n_dev * c) — set c ~ 2N/n^2 for balanced hashes and the total
    per-device cost is O(N/n), the scaling the P3 design owes (overflow is
    *counted*, never silent). The default c = N/n is lossless even if every
    local voxel is unique and hashes to ONE owner, at the price of
    owner-side sorts over N/n-capacity buffers.

    points: (N, 3) sharded over the mesh axis (N divisible by device count).

    Returns (PointCloud sharded over the axis with per-device capacity
    n_dev * bucket_capacity, dropped_points () replicated).
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    per_axis = int(2.0 * bounds / voxel_size) + 2
    if per_axis * per_axis >= 2**31:
        raise ValueError("voxel grid too fine for two-word keys")
    n_local = points.shape[0] // n_dev
    cap = bucket_capacity or n_local

    def stage(pts, cols, val):
        # 1. local exact pre-reduction of the own shard
        sum_pts, sum_col, counts, rep_hi, rep_lo = _local_reduce(
            pts, cols, val, voxel_size, bounds, per_axis)
        occ = (counts > 0) & (rep_hi != _SENTINEL)
        m = counts.shape[0]

        # 2. owner = hash of the voxel key -> device id
        mix = (rep_hi.astype(jnp.uint32) * jnp.uint32(2654435761)
               ^ rep_lo.astype(jnp.uint32) * jnp.uint32(40503))
        owner = (mix % jnp.uint32(n_dev)).astype(jnp.int32)
        owner = jnp.where(occ, owner, n_dev)  # empty record -> overflow bin

        # pack into (n_dev, cap) buckets: position within destination via
        # stable sort by owner + per-segment rank
        order = jnp.argsort(owner, stable=True)
        owner_s = owner[order]
        seg_start = jnp.concatenate(
            [jnp.ones((1,), jnp.int32),
             (owner_s[1:] != owner_s[:-1]).astype(jnp.int32)]
        )
        pos_in_seg = jnp.arange(m, dtype=jnp.int32) - jnp.maximum.accumulate(
            jnp.where(seg_start == 1, jnp.arange(m, dtype=jnp.int32), 0)
        )
        slot = owner_s * cap + pos_in_seg
        keep = (owner_s < n_dev) & (pos_in_seg < cap)
        # overflow accounting in POINTS (each record carries `count` points)
        counts_s = counts[order]
        dropped = jnp.sum(jnp.where(
            (owner_s < n_dev) & (pos_in_seg >= cap), counts_s, 0.0
        )).astype(jnp.int32)

        rec = jnp.concatenate([sum_pts, sum_col, counts[:, None]], axis=1)
        buf_rec = jnp.zeros((n_dev * cap, 7), jnp.float32)
        buf_hi = jnp.full((n_dev * cap,), _SENTINEL, jnp.int32)
        buf_lo = jnp.full((n_dev * cap,), _SENTINEL, jnp.int32)
        # rejected entries target index n_dev*cap == out of range -> dropped
        # by the scatter, so they can never clobber a kept slot
        tgt = jnp.where(keep, slot, n_dev * cap)
        buf_rec = buf_rec.at[tgt].set(rec[order], mode="drop")
        buf_hi = buf_hi.at[tgt].set(jnp.where(keep, rep_hi[order], _SENTINEL),
                                    mode="drop")
        buf_lo = buf_lo.at[tgt].set(jnp.where(keep, rep_lo[order], _SENTINEL),
                                    mode="drop")

        # ship bucket d to device d
        rx_rec = jax.lax.all_to_all(buf_rec.reshape(n_dev, cap, 7), axis,
                                    0, 0, tiled=True).reshape(-1, 7)
        rx_hi = jax.lax.all_to_all(buf_hi.reshape(n_dev, cap), axis,
                                   0, 0, tiled=True).reshape(-1)
        rx_lo = jax.lax.all_to_all(buf_lo.reshape(n_dev, cap), axis,
                                   0, 0, tiled=True).reshape(-1)

        # 3. owner-side exact merge by key over its n_dev*cap records
        tot, out_hi, _ = _merge_records(rx_rec, rx_hi, rx_lo)
        tot_cnt = tot[:, 6]
        occupied = (tot_cnt > 0) & (out_hi != _SENTINEL)
        denom = jnp.maximum(tot_cnt, 1.0)[:, None]
        out_pts = jnp.where(occupied[:, None], tot[:, 0:3] / denom, 0.0)
        out_col = jnp.where(occupied[:, None], tot[:, 3:6] / denom, 0.0)
        return out_pts, out_col, occupied, jax.lax.psum(dropped, axis)

    spec = P(axis)
    out_pts, out_col, occupied, dropped = shard_map(
        stage, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec, spec, P()),
    )(points, colors, valid)
    return PointCloud(points=out_pts, colors=out_col, valid=occupied), dropped


@partial(jax.jit, static_argnames=("voxel_size", "bounds", "mesh"))
def sharded_voxel_downsample(points: jnp.ndarray, colors: jnp.ndarray,
                             valid: jnp.ndarray, mesh: Mesh,
                             voxel_size: float, bounds: float = 2048.0
                             ) -> PointCloud:
    """Voxel-downsample a (N, 3) pool sharded over the mesh's first axis.

    N must divide by the device count. Returns a replicated compacted cloud
    of capacity N (same semantics as mapping.voxel.voxel_downsample).
    """
    axis = mesh.axis_names[0]
    per_axis = int(2.0 * bounds / voxel_size) + 2
    if per_axis * per_axis >= 2**31:
        raise ValueError("voxel grid too fine for two-word keys")

    def stage(points, colors, valid):
        # local dedup only; outputs stay sharded (out_specs concatenates the
        # logical value — XLA inserts the all-gather where the merge needs it)
        return _local_reduce(points, colors, valid, voxel_size, bounds, per_axis)

    spec = P(axis)
    sum_pts, sum_col, counts, rep_hi, rep_lo = shard_map(
        stage, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec, spec, spec, spec),
    )(points, colors, valid)

    # final merge (replicated): second segment reduction over gathered voxels
    n = sum_pts.shape[0]
    order = jnp.argsort(rep_lo, stable=True)
    order = order[jnp.argsort(rep_hi[order], stable=True)]
    hi_s, lo_s = rep_hi[order], rep_lo[order]
    sp, sc, ct = sum_pts[order], sum_col[order], counts[order]
    new_seg = jnp.concatenate(
        [jnp.ones((1,), jnp.int32),
         ((hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])).astype(jnp.int32)]
    )
    seg_id = jnp.cumsum(new_seg) - 1
    tot_pts = jax.ops.segment_sum(sp, seg_id, num_segments=n)
    tot_col = jax.ops.segment_sum(sc, seg_id, num_segments=n)
    tot_cnt = jax.ops.segment_sum(ct, seg_id, num_segments=n)
    seg_hi = jax.ops.segment_min(hi_s, seg_id, num_segments=n)
    occupied = (tot_cnt > 0) & (seg_hi != _SENTINEL)
    denom = jnp.maximum(tot_cnt, 1.0)[:, None]
    return PointCloud(points=tot_pts / denom, colors=tot_col / denom,
                      valid=occupied)
