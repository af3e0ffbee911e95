"""ATE diagnosis: per-frame error decomposition on the bench scene.

Answers: where does the full-stack trajectory's residual ~0.18 m come from,
when optimal fusion of 8 i.i.d. GPS priors through rigid vision links should
reach ~0.11 m?  Reports per-frame |t_err|, VO health (used_vo, inliers),
BA window occupancy, and the error of a one-shot OPTIMAL oracle: a batch
least-squares fuse of all priors with GT relative poses (the information
bound for this estimator class).

Usage (from the repo root): PYTHONPATH=. python tools/ate_diag.py [--frames N]
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
from online_3d_reconstruction.utils.metrics import ate_rmse  # noqa: E402

PRIOR_T_SIGMA = 0.15
PRIOR_R_SIGMA = 0.01


def oracle_fuse(priors: np.ndarray, gt: np.ndarray, window: int,
                kf_frames: "list[int] | None" = None) -> np.ndarray:
    """Information bound: causal+acausal sliding-window fuse of the prior
    translations assuming PERFECT relative poses (vision noise = 0). Each
    KEYFRAME's estimate = gt_k + windowed mean of (prior_i - gt_i) over the
    window where it is oldest — the last solve that touched it. ``kf_frames``
    lists the frame indices that became keyframes (windows slide over
    keyframes, not frames); non-keyframes inherit their preceding keyframe's
    window."""
    n = len(priors)
    kf = sorted(kf_frames) if kf_frames else list(range(n))
    err = priors[:, :3, 3] - gt[:, :3, 3]
    out = gt.copy()
    for k in range(n):
        # position of k's governing keyframe in the keyframe sequence
        pos = max(0, np.searchsorted(kf, k, side="right") - 1)
        idx = [kf[i] for i in range(pos, min(pos + window, len(kf)))]
        out[k, :3, 3] = gt[k, :3, 3] + err[idx].mean(axis=0)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--sgm", action="store_true")
    args = ap.parse_args()

    h, w, d = 384, 512, 64
    rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, baseline=0.5,
                       width=w, height=h)
    scene = SyntheticScene(seed=5, plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)])
    poses = make_survey_trajectory(args.frames, altitude=30.0, speed=1.2)
    dataset = SyntheticSequence(scene=scene, rig=rig, poses=poses,
                                prior_translation_sigma=PRIOR_T_SIGMA,
                                prior_rotation_sigma=PRIOR_R_SIGMA)
    frames = [dataset[i] for i in range(len(dataset))]
    gt = np.stack([f.gt_pose for f in frames])
    priors = np.stack([f.prior_pose for f in frames])

    cfg = PipelineConfig(
        stereo=StereoConfig(height=h, width=w, max_disparity=d, num_paths=8),
        features=FeatureConfig(max_keypoints=512, fast_threshold=5.0),
        odometry=OdometryConfig(ransac_threshold=0.5, max_point_depth=60.0),
        ba=BAConfig(prior_position_weight=1.0 / PRIOR_T_SIGMA**2,
                    prior_rotation_weight=1.0 / PRIOR_R_SIGMA**2),
        mapping=MappingConfig(voxel_size=0.25, map_capacity=2_000_000,
                              frame_point_stride=2, min_depth=1.0,
                              max_depth=60.0),
        runtime=RuntimeConfig(keyframe_translation=0.5, sync_metrics=True,
                              use_precomputed_disparity=not args.sgm),
    )
    eng = OnlineReconstructor(cfg, rig)
    recs = [eng.process(f) for f in frames]
    res = eng.finish()

    traj = res.trajectory
    print(f"{'frm':>3} {'kf':>2} {'vo':>3} {'inl':>4} "
          f"{'|terr|':>7} {'|terr_prior|':>12}")
    for k, r in enumerate(recs):
        te = np.linalg.norm(traj[k, :3, 3] - gt[k, :3, 3])
        tp = np.linalg.norm(priors[k, :3, 3] - gt[k, :3, 3])
        print(f"{k:>3} {int(bool(r.get('keyframe'))):>2} "
              f"{str(r.get('used_vo')):>3} {str(r.get('vo_inliers')):>4} "
              f"{te:7.3f} {tp:12.3f}")

    ate_full = ate_rmse(traj, gt)
    ate_prior = ate_rmse(priors, gt)
    kf_frames = [k for k, r in enumerate(recs) if r.get("keyframe")]
    oracle = oracle_fuse(priors, gt, cfg.ba.window, kf_frames)
    ate_oracle = ate_rmse(oracle, gt)
    # rotation error of the estimate (deg RMS)
    rel = np.einsum("kij,kil->kjl", traj[:, :3, :3], gt[:, :3, :3])
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    print(f"\nATE full {ate_full:.4f}  prior {ate_prior:.4f} "
          f"(ratio {ate_full/ate_prior:.2f})  oracle(W={cfg.ba.window}) "
          f"{ate_oracle:.4f}  rot RMS {np.sqrt((ang**2).mean()):.3f} deg")


if __name__ == "__main__":
    main()
