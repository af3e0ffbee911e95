"""Measure per-link VO relative-pose error on the bench scene (GT disparity).

If consecutive-keyframe VO relatives are cm-accurate, the ATE gap is the BA
weighting/window structure; if they are ~0.1 m, the vision front end itself
(detection/matching/lift) is the limiter.

Usage (from the repo root): PYTHONPATH=. python tools/vo_link_err.py [--frames N] [--sgm]
"""
from __future__ import annotations

import argparse

import numpy as np

from online_3d_reconstruction.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from online_3d_reconstruction.config import (  # noqa: E402
    BAConfig, FeatureConfig, MappingConfig, OdometryConfig, PipelineConfig,
    RuntimeConfig, StereoConfig)
from online_3d_reconstruction.io.calibration import identity_rig  # noqa: E402
from online_3d_reconstruction.io.dataset import SyntheticSequence  # noqa: E402
from online_3d_reconstruction.io.synthetic import (  # noqa: E402
    Plateau, SyntheticScene, make_survey_trajectory)
from online_3d_reconstruction.runtime.pipeline import OnlineReconstructor  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--sgm", action="store_true")
    args = ap.parse_args()

    h, w, d = 384, 512, 64
    rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, baseline=0.5,
                       width=w, height=h)
    scene = SyntheticScene(seed=5, plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)])
    poses = make_survey_trajectory(args.frames, altitude=30.0, speed=1.2)
    dataset = SyntheticSequence(scene=scene, rig=rig, poses=poses,
                                prior_translation_sigma=0.15,
                                prior_rotation_sigma=0.01)
    frames = [dataset[i] for i in range(len(dataset))]
    gt = np.stack([f.gt_pose for f in frames])

    # VO only, no BA: pose_k = pose_{k-1} o rel_vo -> per-link error is the
    # difference of consecutive absolute errors
    cfg = PipelineConfig(
        stereo=StereoConfig(height=h, width=w, max_disparity=d, num_paths=8),
        features=FeatureConfig(max_keypoints=512, fast_threshold=5.0),
        odometry=OdometryConfig(ransac_threshold=0.5, max_point_depth=60.0),
        ba=BAConfig(),
        mapping=MappingConfig(voxel_size=0.25, map_capacity=2_000_000,
                              frame_point_stride=2, min_depth=1.0,
                              max_depth=60.0),
        runtime=RuntimeConfig(keyframe_translation=0.5, sync_metrics=True,
                              ba_every_keyframe=False, host_ba=False,
                              use_precomputed_disparity=not args.sgm),
    )
    # The prior fallback stays ENABLED (its use is visible via used_vo); the
    # frontend composes rel onto the PREVIOUS KEYFRAME pose, so consecutive
    # pose errors differ exactly by the link error.
    eng = OnlineReconstructor(cfg, rig)
    recs = [eng.process(f) for f in frames]
    res = eng.finish()
    traj = res.trajectory

    print(f"{'lnk':>3} {'vo':>3} {'inl':>4} {'|dt_err|':>9} "
          f"{'dxyz_err':>27} {'drot_deg':>8}")
    errs = []
    for k in range(1, len(frames)):
        # link error: GT^-1(rel) vs est rel between consecutive frames
        rel_est = np.linalg.inv(traj[k - 1]) @ traj[k]
        rel_gt = np.linalg.inv(gt[k - 1]) @ gt[k]
        d_ = np.linalg.inv(rel_gt) @ rel_est
        dt = d_[:3, 3]
        ang = np.degrees(np.arccos(np.clip((np.trace(d_[:3, :3]) - 1) / 2,
                                           -1, 1)))
        errs.append(dt)
        r = recs[k]
        print(f"{k:>3} {str(r.get('used_vo')):>3} {str(r.get('vo_inliers')):>4}"
              f" {np.linalg.norm(dt):9.4f} "
              f"[{dt[0]:8.4f} {dt[1]:8.4f} {dt[2]:8.4f}] {ang:8.4f}")
    errs = np.asarray(errs)
    print(f"\nper-link dt RMS: {np.sqrt((errs**2).sum(1).mean()):.4f} m, "
          f"per-axis RMS {np.sqrt((errs**2).mean(0))}, "
          f"mean bias {errs.mean(0)}")


if __name__ == "__main__":
    main()
