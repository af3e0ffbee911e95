"""Trajectory regression (SURVEY.md §4.5): a multi-row survey flight through
the full online loop — keyframes, window BA, voxel map — with drift bounds."""

import numpy as np

from online_3d_reconstruction.io.dataset import SyntheticSequence
from online_3d_reconstruction.io.synthetic import make_survey_trajectory
from online_3d_reconstruction.runtime.pipeline import reconstruct
from online_3d_reconstruction.utils.metrics import ate_rmse, rpe_stats

from tests.test_odometry import _test_config, vo_rig, vo_scene  # noqa: F401


def test_survey_sequence_regression(vo_scene, vo_rig):
    """24-frame lawnmower survey: two rows + a turn (yaw and direction flip)."""
    cfg = _test_config()
    poses = make_survey_trajectory(
        24, altitude=12.0, speed=0.7, row_length=7.0, row_spacing=2.5, seed=2
    )
    dataset = SyntheticSequence(
        scene=vo_scene, rig=vo_rig, poses=poses,
        prior_translation_sigma=0.25, prior_rotation_sigma=0.015,
    )
    result = reconstruct(dataset, cfg, vo_rig)

    gt = np.stack(poses)
    ate = ate_rmse(result.trajectory, gt)
    rpe_t, rpe_r = rpe_stats(result.trajectory, gt)
    assert result.metrics["frames"] == 24
    assert result.metrics["keyframes"] >= 10
    # regression bounds: chained VO + BA over a 16 m track with noisy priors
    # (frames travel as uint8 — what a real camera delivers — so the VO sees
    # 8-bit-quantized images; the bound allows for that)
    assert ate < 0.6, f"ATE {ate:.3f} m"
    assert rpe_t < 0.17, f"RPE-t {rpe_t:.3f} m"
    assert rpe_r < 0.02, f"RPE-r {rpe_r:.4f} rad"
    # the map covers both survey rows
    assert len(result.map_points) > 2_000
    y_extent = result.map_points[:, 1].max() - result.map_points[:, 1].min()
    assert y_extent > 4.0, f"map y-extent {y_extent:.1f} (expected both rows)"


def test_full_stack_beats_prior_dead_reckoning(vo_scene, vo_rig):
    """The vision stack must EARN its keep over dead-reckoning on the raw
    flight-log priors (the north-star quality criterion): full-stack ATE
    <= 0.8x prior-only on a short GT-disparity sequence.

    Runs in the device-independent CPU suite so the estimator-quality
    evidence never depends on an accelerator run: a silent estimator no-op — like the r4 bf16 normal
    equations or the r5 bf16 rigid_transform — pushes full-stack ATE to
    ~1.0x prior and fails here. The 0.8x bound is loose (the bench scene
    reaches 0.47x with the tuned window; this short 12-frame window-limited
    run reaches ~0.6x) so seed noise cannot flake it.
    """
    import dataclasses

    from online_3d_reconstruction.config import BAConfig

    cfg = _test_config()
    cfg = dataclasses.replace(
        cfg,
        # the PRODUCT estimator configuration (bench.py): whitened 3x3
        # stereo information, huber at 3 sigma, priors at their true
        # 1/sigma^2 information
        ba=BAConfig(obs_weighting=True, sigma_pixel=0.5,
                    sigma_disparity=1.0, huber_delta=3.0,
                    prior_position_weight=1.0 / 0.2**2,
                    prior_rotation_weight=1.0 / 0.01**2),
        runtime=dataclasses.replace(cfg.runtime,
                                    use_precomputed_disparity=True),
    )
    # pixel-footprint anti-aliased render (supersample=2): the whitened
    # estimator weights subpixel feature positions at 1/(0.5 px)^2 — on a
    # POINT-SAMPLED render those positions carry structured ~1 px aliasing
    # bias and the tightly-weighted BA diverges (the r4 finding; measured
    # here: 9.8x prior with ss=1, 0.6x with ss=2). A real sensor integrates
    # over the pixel, so ss=2 is the physically-honest camera model.
    from online_3d_reconstruction.io.synthetic import Plateau, SyntheticScene

    scene = SyntheticScene(
        seed=11,
        plateaus=[Plateau(x_min=-3.0, x_max=3.0, y_min=-2.0, y_max=4.0,
                          height=4.0)],
        supersample=2,
    )
    poses = make_survey_trajectory(12, altitude=12.0, speed=0.7,
                                   row_length=7.0, seed=5)
    dataset = SyntheticSequence(scene=scene, rig=vo_rig, poses=poses,
                                prior_translation_sigma=0.2,
                                prior_rotation_sigma=0.01)
    frames = [dataset[i] for i in range(len(dataset))]
    gt = np.stack(poses)
    priors = np.stack([f.prior_pose for f in frames])
    result = reconstruct(frames, cfg, vo_rig)

    ate_prior = ate_rmse(priors, gt)
    ate_full = ate_rmse(result.trajectory, gt)
    assert ate_full <= 0.8 * ate_prior, (
        f"full-stack ATE {ate_full:.3f} m vs prior-only {ate_prior:.3f} m "
        f"({ate_full / ate_prior:.2f}x) — the estimator is not earning its "
        "keep; check for silent precision regressions in the pose math")


def test_precomputed_disparity_bypasses_sgm(vo_scene, vo_rig, monkeypatch):
    """Offline mode (SURVEY.md §2.1 C5 'precomputed disparity'): with
    runtime.use_precomputed_disparity the SGM stage must never run — the
    supplied (ground-truth) maps feed features + backprojection directly."""
    import dataclasses

    from online_3d_reconstruction.runtime import pipeline as pl

    def _boom(*a, **k):
        raise AssertionError("sgm_disparity ran in precomputed mode")

    monkeypatch.setattr(pl, "sgm_disparity", _boom)

    cfg = _test_config()
    cfg = dataclasses.replace(
        cfg,
        runtime=dataclasses.replace(cfg.runtime,
                                    use_precomputed_disparity=True),
    )
    poses = make_survey_trajectory(8, altitude=12.0, speed=0.7,
                                   row_length=7.0, seed=3)
    dataset = SyntheticSequence(scene=vo_scene, rig=vo_rig, poses=poses,
                                prior_translation_sigma=0.15)
    assert dataset[0].disparity is not None  # the oracle supplies GT maps
    result = reconstruct(dataset, cfg, vo_rig)

    # GT disparity -> exact lifts: the trajectory should beat noisy priors
    ate = ate_rmse(result.trajectory, np.stack(poses))
    assert ate < 0.35, f"ATE {ate:.3f} m with GT disparity"
    # 8 frames over one ~7 m row at 0.5 m leaves -> a few hundred voxels
    assert len(result.map_points) > 400


def test_profile_flag_writes_trace(vo_scene, vo_rig, tmp_path):
    """runtime.profile wraps the run in a jax.profiler trace (SURVEY.md §5)."""
    import dataclasses
    import os

    from online_3d_reconstruction.io.dataset import SyntheticSequence
    from online_3d_reconstruction.io.synthetic import nadir_pose

    cfg = _test_config()
    cfg = dataclasses.replace(
        cfg,
        runtime=dataclasses.replace(cfg.runtime, profile=True,
                                    checkpoint_dir=str(tmp_path)),
    )
    ds = SyntheticSequence(scene=vo_scene, rig=vo_rig,
                           poses=[nadir_pose(0, 0, 12.0)])
    reconstruct(ds, cfg, vo_rig)
    trace_dir = tmp_path / "profile"
    assert trace_dir.exists()
    found = [f for _, _, fs in os.walk(trace_dir) for f in fs]
    assert found, "no trace files written"
