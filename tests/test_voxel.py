"""Voxel downsample vs a numpy PCL-semantics oracle; global map pool ops."""

import numpy as np

import jax.numpy as jnp

from online_3d_reconstruction.geometry.backproject import PointCloud
from online_3d_reconstruction.mapping.global_map import (
    create_map,
    downsample_map,
    insert_cloud,
    map_to_numpy,
    needs_downsample,
)
from online_3d_reconstruction.mapping.voxel import voxel_downsample


def _np_voxel_filter(points, colors, valid, voxel, bounds):
    """Dict-based PCL VoxelGrid semantics: centroid of points+colors per leaf."""
    cells = {}
    for p, c, v in zip(points, colors, valid):
        if not v:
            continue
        key = tuple(np.floor((p + bounds) / voxel).astype(int))
        cells.setdefault(key, []).append((p, c))
    pts = np.array([np.mean([p for p, _ in v], axis=0) for v in cells.values()])
    cols = np.array([np.mean([c for _, c in v], axis=0) for v in cells.values()])
    return pts, cols


def _rand_cloud(rng, n, scale=4.0, valid_frac=0.9):
    return PointCloud(
        points=jnp.asarray(rng.normal(0, scale, (n, 3)).astype(np.float32)),
        colors=jnp.asarray(rng.random((n, 3)).astype(np.float32)),
        valid=jnp.asarray(rng.random(n) < valid_frac),
    )


class TestVoxelDownsample:
    def test_matches_numpy_oracle(self):
        rng = np.random.default_rng(0)
        cloud = _rand_cloud(rng, 512)
        out = voxel_downsample(cloud, voxel_size=1.0, bounds=64.0)
        ref_pts, ref_cols = _np_voxel_filter(
            np.asarray(cloud.points), np.asarray(cloud.colors),
            np.asarray(cloud.valid), 1.0, 64.0,
        )
        got_pts = np.asarray(out.points)[np.asarray(out.valid)]
        got_cols = np.asarray(out.colors)[np.asarray(out.valid)]
        assert len(got_pts) == len(ref_pts)
        # order-insensitive compare: sort both by coordinates
        o1 = np.lexsort(got_pts.T)
        o2 = np.lexsort(ref_pts.T)
        np.testing.assert_allclose(got_pts[o1], ref_pts[o2], atol=1e-4)
        np.testing.assert_allclose(got_cols[o1], ref_cols[o2], atol=1e-4)

    def test_compacted_to_front(self):
        rng = np.random.default_rng(1)
        out = voxel_downsample(_rand_cloud(rng, 256), voxel_size=2.0, bounds=64.0)
        v = np.asarray(out.valid)
        k = v.sum()
        assert v[:k].all() and not v[k:].any()

    def test_idempotent(self):
        rng = np.random.default_rng(2)
        once = voxel_downsample(_rand_cloud(rng, 256), voxel_size=1.0, bounds=64.0)
        twice = voxel_downsample(once, voxel_size=1.0, bounds=64.0)
        assert np.asarray(once.valid).sum() == np.asarray(twice.valid).sum()

    def test_out_of_bounds_dropped(self):
        cloud = PointCloud(
            points=jnp.asarray([[0.0, 0.0, 0.0], [100.0, 0.0, 0.0]]),
            colors=jnp.zeros((2, 3)),
            valid=jnp.asarray([True, True]),
        )
        out = voxel_downsample(cloud, voxel_size=1.0, bounds=8.0)
        assert np.asarray(out.valid).sum() == 1


class TestGlobalMap:
    def test_insert_then_downsample(self):
        rng = np.random.default_rng(3)
        gmap = create_map(capacity=2048)
        for i in range(3):
            gmap = insert_cloud(gmap, _rand_cloud(rng, 256, scale=2.0))
        assert int(gmap.cursor) == 768
        gmap = downsample_map(gmap, voxel_size=0.5, bounds=64.0)
        survivors = int(np.asarray(gmap.valid).sum())
        assert int(gmap.cursor) == survivors
        assert 0 < survivors <= 768
        pts, cols = map_to_numpy(gmap)
        assert pts.shape == (survivors, 3)

    def test_capacity_clamp_and_trigger(self):
        rng = np.random.default_rng(4)
        gmap = create_map(capacity=300)
        gmap = insert_cloud(gmap, _rand_cloud(rng, 256))
        assert bool(needs_downsample(gmap, 256))
        gmap2 = insert_cloud(gmap, _rand_cloud(rng, 256))  # clamps, no crash
        assert int(gmap2.cursor) == 300
