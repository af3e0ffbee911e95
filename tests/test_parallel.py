"""Multi-device sharding on the simulated 8-device CPU mesh (SURVEY.md §4.4):
the real shard_map code paths, asserted equivalent to the 1-device results."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from online_3d_reconstruction.ba.schur import solve_ba
from online_3d_reconstruction.config import StereoConfig
from online_3d_reconstruction.geometry.backproject import PointCloud
from online_3d_reconstruction.mapping.voxel import voxel_downsample
from online_3d_reconstruction.parallel import (
    batch_disparity,
    make_mesh,
    sharded_voxel_downsample,
    solve_ba_sharded,
)
from tests.test_ba import _make_problem


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(8)


class TestShardedBA:
    def test_matches_single_device(self, mesh8):
        rng = np.random.default_rng(0)
        problem, gt_poses, _ = _make_problem(rng, w=4, l=24, obs_noise=0.01)
        p1, l1, t1 = solve_ba(problem, iters=4, damping=1e-4, huber_delta=0.5)
        p8, l8, t8 = solve_ba_sharded(problem, mesh8, iters=4, damping=1e-4,
                                      huber_delta=0.5)
        np.testing.assert_allclose(np.asarray(p8), np.asarray(p1),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(t8), np.asarray(t1), rtol=1e-4)

    def test_uneven_observation_count_padded(self, mesh8):
        rng = np.random.default_rng(1)
        # 3 kf x 11 lm = 33 obs: not divisible by 8 -> exercises padding
        problem, _, _ = _make_problem(rng, w=3, l=11)
        p1, _, _ = solve_ba(problem, iters=3, damping=1e-4, huber_delta=0.0)
        p8, _, _ = solve_ba_sharded(problem, mesh8, iters=3, damping=1e-4,
                                    huber_delta=0.0)
        np.testing.assert_allclose(np.asarray(p8), np.asarray(p1),
                                   rtol=1e-4, atol=1e-5)


class TestShardedWindowBA:
    def test_keyframe_core_matches_single_device(self, mesh8):
        """The distributed loop's device-window keyframe event (track build +
        psum-sharded Schur solve) must reproduce the single-device solve —
        the path that replaced the forced host-BA downgrade."""
        from online_3d_reconstruction.ba.device_tracks import (
            create_window,
            keyframe_core,
        )
        from online_3d_reconstruction.config import BAConfig

        cfg = BAConfig(window=4, max_landmarks=64, max_obs=512)
        k = 64
        rng = np.random.default_rng(7)

        def run(mesh):
            state = create_window(cfg.window, k)
            refined = None
            for i in range(5):
                pts = rng.bit_generator.state  # keep rng in sync across runs
                rng2 = np.random.default_rng(100 + i)
                points = rng2.normal(0, 3, (k, 3)).astype(np.float32)
                valid = rng2.random(k) < 0.9
                match_idx = rng2.integers(0, k, k).astype(np.int32)
                match_ok = rng2.random(k) < 0.7
                pose = np.eye(4, dtype=np.float32)
                pose[:3, 3] = [i, 0.1 * i, 0.0]
                state, refined, _ = keyframe_core(
                    state, jnp.asarray(points), jnp.asarray(valid),
                    jnp.asarray(match_idx), jnp.asarray(match_ok),
                    jnp.asarray(pose), jnp.asarray(pose), cfg, mesh)
            return np.asarray(refined)

        single = run(None)
        sharded = run(mesh8)
        np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-5)


class TestBatchDisparity:
    def test_sharded_matches_unsharded(self, mesh8, scene, small_rig):
        from online_3d_reconstruction.io.synthetic import nadir_pose

        cfg = StereoConfig(height=192, width=256, max_disparity=16,
                           num_paths=2, speckle_window=0)
        frames = [
            scene.render_stereo(nadir_pose(2.0 * i, 0.0, 24.0), small_rig)
            for i in range(8)
        ]
        lefts = jnp.stack([jnp.asarray(f.left) for f in frames])
        rights = jnp.stack([jnp.asarray(f.right) for f in frames])
        d_ref, v_ref = batch_disparity(lefts, rights, cfg, mesh=None)
        d_sh, v_sh = batch_disparity(lefts, rights, cfg, mesh=mesh8)
        np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_ref), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(v_sh), np.asarray(v_ref))


class TestShardedVoxel:
    def test_matches_single_device(self, mesh8):
        rng = np.random.default_rng(2)
        n = 1024  # divisible by 8
        cloud = PointCloud(
            points=jnp.asarray(rng.normal(0, 4, (n, 3)).astype(np.float32)),
            colors=jnp.asarray(rng.random((n, 3)).astype(np.float32)),
            valid=jnp.asarray(rng.random(n) < 0.9),
        )
        ref = voxel_downsample(cloud, voxel_size=1.0, bounds=64.0)
        out = sharded_voxel_downsample(cloud.points, cloud.colors, cloud.valid,
                                       mesh8, voxel_size=1.0, bounds=64.0)
        ref_pts = np.asarray(ref.points)[np.asarray(ref.valid)]
        out_pts = np.asarray(out.points)[np.asarray(out.valid)]
        assert len(ref_pts) == len(out_pts)
        o1 = np.lexsort(ref_pts.T)
        o2 = np.lexsort(out_pts.T)
        np.testing.assert_allclose(out_pts[o2], ref_pts[o1], atol=1e-4)


class TestShardedSGM:
    def test_row_slab_matches_monolithic(self, mesh8, scene, small_rig):
        from online_3d_reconstruction.io.synthetic import nadir_pose
        from online_3d_reconstruction.parallel.sgm_sharded import sharded_disparity
        from online_3d_reconstruction.stereo.sgm import sgm_disparity

        cfg = StereoConfig(height=192, width=256, max_disparity=32,
                           num_paths=8)
        f = scene.render_stereo(nadir_pose(0.0, 0.0, 24.0), small_rig)
        left = jnp.asarray(f.left)
        right = jnp.asarray(f.right)
        d_ref, v_ref = sgm_disparity(left, right, cfg)
        d_sh, v_sh = sharded_disparity(left, right, cfg, mesh8, halo=16)

        ref = np.asarray(d_ref)
        sh = np.asarray(d_sh)
        both = np.asarray(v_ref) & np.asarray(v_sh)
        # halo truncation only perturbs pixels whose winning path crossed a
        # slab boundary more than `halo` rows away; this test geometry is
        # extreme (24-row slabs) — exact-match is ~97.7%, within-1px ~always
        exact = np.abs(ref[both] - sh[both]) < 0.01
        close = np.abs(ref[both] - sh[both]) <= 1.0
        assert both.mean() > 0.5
        assert exact.mean() > 0.95, f"exact agreement {exact.mean():.4f}"
        assert close.mean() > 0.995, f"1px agreement {close.mean():.4f}"

    def test_rejects_bad_geometry(self, mesh8, scene, small_rig):
        from online_3d_reconstruction.parallel.sgm_sharded import sharded_disparity

        cfg = StereoConfig(height=192, width=256, max_disparity=16,
                           num_paths=2)
        with pytest.raises(ValueError):
            sharded_disparity(jnp.zeros((190, 256)), jnp.zeros((190, 256)),
                              cfg, mesh8)  # 190 % 8 != 0
        with pytest.raises(ValueError):
            sharded_disparity(jnp.zeros((192, 256)), jnp.zeros((192, 256)),
                              cfg, mesh8, halo=32)  # slab 24 <= halo 32


class TestVoxelRouteMerge:
    def test_matches_global_downsample(self, mesh8):
        from online_3d_reconstruction.parallel.voxel_sharded import (
            voxel_route_merge,
        )

        rng = np.random.default_rng(5)
        n = 1024
        cloud = PointCloud(
            points=jnp.asarray(rng.normal(0, 4, (n, 3)).astype(np.float32)),
            colors=jnp.asarray(rng.random((n, 3)).astype(np.float32)),
            valid=jnp.asarray(rng.random(n) < 0.9),
        )
        ref = voxel_downsample(cloud, voxel_size=1.0, bounds=64.0)
        out, dropped = voxel_route_merge(cloud.points, cloud.colors, cloud.valid,
                                         mesh8, voxel_size=1.0, bounds=64.0)
        assert int(dropped) == 0  # default bucket capacity is lossless
        ref_pts = np.asarray(ref.points)[np.asarray(ref.valid)]
        out_pts = np.asarray(out.points)[np.asarray(out.valid)]
        ref_cols = np.asarray(ref.colors)[np.asarray(ref.valid)]
        out_cols = np.asarray(out.colors)[np.asarray(out.valid)]
        assert len(ref_pts) == len(out_pts)
        o1 = np.lexsort(ref_pts.T)
        o2 = np.lexsort(out_pts.T)
        np.testing.assert_allclose(out_pts[o2], ref_pts[o1], atol=1e-4)
        np.testing.assert_allclose(out_cols[o2], ref_cols[o1], atol=1e-4)

    def test_overflow_counted(self, mesh8):
        from online_3d_reconstruction.parallel.voxel_sharded import (
            voxel_route_merge,
        )

        rng = np.random.default_rng(6)
        n = 1024
        pts = jnp.asarray(rng.normal(0, 30, (n, 3)).astype(np.float32))
        out, dropped = voxel_route_merge(
            pts, jnp.zeros((n, 3)), jnp.ones(n, bool),
            mesh8, voxel_size=0.25, bounds=64.0, bucket_capacity=4,
        )
        assert int(dropped) > 0  # tiny buckets must overflow and be counted


class TestSlotShardedBA:
    """Keyframe-sharded (slot-major) distributed Schur — the large-window P2
    form: per-device accumulation O((N/n)*L), one psum (landmark blocks) +
    one all_gather (pose blocks) per GN iteration."""

    def test_matches_single_device(self, mesh8):
        from online_3d_reconstruction.ba.testing import make_synthetic_bundle
        from online_3d_reconstruction.parallel.ba_sharded import (
            solve_ba_slot_sharded,
        )

        rng = np.random.default_rng(7)
        w, l, k = 16, 128, 32
        problem, _, _ = make_synthetic_bundle(rng, w=w, l=l, obs_noise=0.02,
                                              n_cap=w * k, obs_per_kf=k)
        p1, l1, t1 = solve_ba(problem, iters=4, damping=1e-4, huber_delta=0.5,
                              slot_major=k)
        p8, l8, t8 = solve_ba_slot_sharded(problem, mesh8, slot_major=k,
                                           iters=4, damping=1e-4,
                                           huber_delta=0.5)
        np.testing.assert_allclose(np.asarray(p8), np.asarray(p1),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(l8), np.asarray(l1),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(t8), np.asarray(t1), rtol=1e-4)

    def test_rejects_bad_layout(self, mesh8):
        from online_3d_reconstruction.ba.testing import make_synthetic_bundle
        from online_3d_reconstruction.parallel.ba_sharded import (
            solve_ba_slot_sharded,
        )

        rng = np.random.default_rng(8)
        problem, _, _ = make_synthetic_bundle(rng, w=6, l=16, n_cap=6 * 16)
        with pytest.raises(ValueError, match="slot-sharded"):
            solve_ba_slot_sharded(problem, mesh8, slot_major=16, iters=1)
