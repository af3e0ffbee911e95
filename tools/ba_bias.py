"""Evaluate the built BA problem's observation residuals AT GROUND TRUTH.

Landmarks are re-solved in closed form under the GT poses (per-track mean of
the world-lifted observations), so the remaining residual is pure
observation error. Per-keyframe mean residual exposes any frame-level
correlated bias — the failure mode that makes strong observation weights
HURT (tools/ate_lab.py: ATE rises monotonically as sigma_px drops).

Usage (from the repo root): PYTHONPATH=. python tools/ba_bias.py [--frames N] [--sgm]
"""
from __future__ import annotations

import argparse

import numpy as np

from online_3d_reconstruction.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from online_3d_reconstruction.ba.device_tracks import build_problem  # noqa: E402
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
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--sgm", action="store_true")
    ap.add_argument("--ss", type=int, default=2,
                    help="render supersampling (2 = bench's AA camera model)")
    ap.add_argument("--no-subpixel", action="store_true",
                    help="disable subpixel keypoint refinement")
    args = ap.parse_args()

    h, w, d = 384, 512, 64
    rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, baseline=0.5,
                       width=w, height=h)
    scene = SyntheticScene(seed=5, plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)],
                           supersample=args.ss)
    poses = make_survey_trajectory(args.frames, altitude=30.0, speed=1.2)
    dataset = SyntheticSequence(scene=scene, rig=rig, poses=poses,
                                prior_translation_sigma=0.15,
                                prior_rotation_sigma=0.01)
    frames = [dataset[i] for i in range(len(dataset))]
    gt = np.stack([f.gt_pose for f in frames])

    cfg = PipelineConfig(
        stereo=StereoConfig(height=h, width=w, max_disparity=d, num_paths=8),
        features=FeatureConfig(max_keypoints=512, fast_threshold=5.0,
                               subpixel=not args.no_subpixel),
        odometry=OdometryConfig(ransac_threshold=0.5, max_point_depth=60.0),
        ba=BAConfig(prior_position_weight=1.0 / 0.15**2,
                    prior_rotation_weight=1.0 / 0.01**2),
        mapping=MappingConfig(voxel_size=0.25, map_capacity=2_000_000,
                              frame_point_stride=2, min_depth=1.0,
                              max_depth=60.0),
        runtime=RuntimeConfig(keyframe_translation=0.5, sync_metrics=False,
                              use_precomputed_disparity=not args.sgm),
    )
    eng = OnlineReconstructor(cfg, rig)
    for f in frames:
        eng.process(f)

    state = eng._ba_state
    problem, stats = build_problem(state, cfg.ba.max_landmarks)
    live = int(state.count)
    kf_idx = [k.index for k in eng.keyframes[-live:]]
    print(f"window live={live} keyframes={kf_idx} "
          f"landmarks={int(stats['landmarks'])} "
          f"obs={int(stats['observations'])}")

    obs_kf = np.asarray(problem.obs_kf)
    obs_lm = np.asarray(problem.obs_lm)
    obs_pt = np.asarray(problem.obs_point)
    ok = np.asarray(problem.obs_valid)

    # GT pose per slot; obs_kf covers all window slots, so clip indices into
    # the live range (invalid observations are masked by `ok` anyway)
    obs_kf = np.clip(obs_kf, 0, live - 1)
    gt_slot = np.stack([gt[kf_idx[s]] for s in range(live)])
    r_gt = gt_slot[:, :3, :3]
    t_gt = gt_slot[:, :3, 3]

    # world lift at GT, per-track mean -> closed-form landmark under GT
    world = np.einsum("nij,nj->ni", r_gt[obs_kf], obs_pt) + t_gt[obs_kf]
    l_cap = problem.landmarks.shape[0]
    cnt = np.bincount(obs_lm[ok], minlength=l_cap).astype(np.float64)
    lm = np.zeros((l_cap, 3))
    for a in range(3):
        lm[:, a] = np.bincount(obs_lm[ok], weights=world[ok, a],
                               minlength=l_cap)
    lm /= np.maximum(cnt, 1.0)[:, None]

    # camera-frame residual at GT
    res = np.einsum("nji,nj->ni",
                    r_gt[obs_kf], lm[obs_lm] - t_gt[obs_kf]) - obs_pt
    print(f"\nobs residual at GT: per-axis RMS "
          f"{np.sqrt((res[ok]**2).mean(0))} (camera frame x,y,z)")
    print(f"{'slot':>4} {'frm':>4} {'nobs':>5}  mean residual (bias)      RMS")
    for s in range(live):
        m = ok & (obs_kf == s)
        if m.sum() == 0:
            continue
        bias = res[m].mean(0)
        rms = np.sqrt((res[m] ** 2).mean(0))
        print(f"{s:>4} {kf_idx[s]:>4} {int(m.sum()):>5} "
              f"[{bias[0]:8.4f} {bias[1]:8.4f} {bias[2]:8.4f}] "
              f"[{rms[0]:7.4f} {rms[1]:7.4f} {rms[2]:7.4f}]")

    # track-length histogram
    tl = cnt[cnt > 0].astype(int)
    print(f"\ntrack length histogram: "
          f"{dict(zip(*np.unique(tl, return_counts=True)))}")


if __name__ == "__main__":
    main()
