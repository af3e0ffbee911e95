"""End-to-end odometry: two-frame pose recovery + 10-frame online sequence.

Config [B:8] of the driver ladder: "10-frame sequence: feature match +
pairwise pose correction + voxel fusion" — exercised through the real
``OnlineReconstructor``/``reconstruct`` product path, validated against the
synthetic oracle's exact trajectory (SURVEY.md §4.2, §4.5).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from online_3d_reconstruction.config import (
    FeatureConfig,
    MappingConfig,
    MatchConfig,
    OdometryConfig,
    PipelineConfig,
    RuntimeConfig,
    StereoConfig,
)
from online_3d_reconstruction.geometry import se3
from online_3d_reconstruction.io.calibration import identity_rig
from online_3d_reconstruction.io.dataset import SyntheticSequence
from online_3d_reconstruction.io.synthetic import (
    Plateau,
    SyntheticScene,
    nadir_pose,
)
from online_3d_reconstruction.odometry.frontend import (
    extract_frame_features,
    odometry_step,
)
from online_3d_reconstruction.runtime.pipeline import reconstruct
from online_3d_reconstruction.stereo.sgm import sgm_disparity
from online_3d_reconstruction.utils.metrics import ate_rmse, rpe_stats


def _test_config():
    return PipelineConfig(
        stereo=StereoConfig(height=192, width=256, max_disparity=32,
                            num_paths=4),
        features=FeatureConfig(max_keypoints=512, fast_threshold=5.0),
        matching=MatchConfig(ratio=0.9, max_hamming=80),
        odometry=OdometryConfig(ransac_threshold=0.5, min_inliers=10,
                                max_point_depth=40.0),
        mapping=MappingConfig(voxel_size=0.5, map_capacity=200_000,
                              frame_point_stride=2, bounds=256.0,
                              min_depth=1.0, max_depth=40.0),
        runtime=RuntimeConfig(keyframe_translation=0.3, keyframe_rotation=0.05),
    )


@pytest.fixture(scope="module")
def vo_rig():
    return identity_rig(fx=300.0, fy=300.0, cx=128.0, cy=96.0, baseline=0.5,
                        width=256, height=192)


@pytest.fixture(scope="module")
def vo_scene():
    return SyntheticScene(
        seed=11,
        plateaus=[Plateau(x_min=-3.0, x_max=3.0, y_min=-2.0, y_max=4.0, height=4.0)],
    )


class TestTwoFrameVO:
    def test_recovers_known_relative_pose(self, vo_scene, vo_rig):
        cfg = _test_config()
        pose0 = nadir_pose(0.0, 0.0, 12.0)
        pose1 = nadir_pose(0.8, 0.15, 12.0, yaw=0.02)
        frames = [vo_scene.render_stereo(p, vo_rig) for p in (pose0, pose1)]
        q = jnp.asarray(vo_rig.q, dtype=jnp.float32)

        feats = []
        for f in frames:
            disp, _ = sgm_disparity(jnp.asarray(f.left), jnp.asarray(f.right),
                                    cfg.stereo)
            feats.append(
                extract_frame_features(jnp.asarray(f.left), disp, q,
                                       cfg.features, cfg.odometry)
            )

        gt_rel = jnp.asarray(np.linalg.inv(pose0) @ pose1, dtype=jnp.float32)
        bad_prior = jnp.eye(4)  # prior deliberately wrong: VO must not use it
        rel, used_vo, count, _ = odometry_step(
            feats[1], feats[0], bad_prior, jax.random.PRNGKey(0),
            cfg.matching, cfg.odometry,
        )
        assert bool(used_vo), f"VO gate failed with {int(count)} inliers"
        t_err, r_err = se3.geodesic_distance(gt_rel, rel)
        # single-pair single-seed RANSAC: a 1-2 descriptor-bit change can
        # swap one marginal match and move the estimate by ~0.01-0.02 m, so
        # the bound carries that implementation-noise allowance (sequence
        # ATE/RPE bounds in test_sequence are the tight end-to-end gate)
        assert float(t_err) < 0.18, f"translation error {float(t_err):.3f} m"
        assert float(r_err) < 0.02, f"rotation error {float(r_err):.4f} rad"


class TestTenFrameSequence:
    def test_online_loop_tracks_and_fuses(self, vo_scene, vo_rig):
        cfg = _test_config()
        poses = [nadir_pose(0.8 * i, 0.1 * i, 12.0, yaw=0.01 * i) for i in range(10)]
        dataset = SyntheticSequence(
            scene=vo_scene, rig=vo_rig, poses=poses,
            prior_translation_sigma=0.3, prior_rotation_sigma=0.02,
        )
        result = reconstruct(dataset, cfg, vo_rig)

        assert result.trajectory.shape == (10, 4, 4)
        assert len(result.keyframe_indices) >= 5   # moving 0.8 m/frame

        gt = np.stack(poses)
        ate = ate_rmse(result.trajectory, gt)
        rpe_t, rpe_r = rpe_stats(result.trajectory, gt)
        # priors are sigma=0.3 noise; VO must beat dead-reckoning the priors
        prior_traj = np.stack([f.prior_pose for f in dataset])
        prior_rpe_t, _ = rpe_stats(prior_traj, gt)
        assert ate < 0.5, f"ATE {ate:.3f} m"
        assert rpe_t < prior_rpe_t, f"VO RPE {rpe_t:.3f} not better than prior {prior_rpe_t:.3f}"

        # map sanity: fused cloud sits on the two GT surfaces (z=0 and z=4).
        # ~17x8 m of terrain at 0.5 m voxels -> O(1-2k) occupied leaves.
        assert len(result.map_points) > 1_000
        z = result.map_points[:, 2]
        assert np.median(np.minimum(np.abs(z), np.abs(z - 4.0))) < 0.5
        assert result.metrics["frames"] == 10
        assert result.metrics["vo_inliers"] > 10
