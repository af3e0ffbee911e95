"""Build the bench scene's real-SGM disparity cache on the GPU.

tools/ate_lab.py --sgm-cache sweeps estimator configs against cached
real-SGM disparity maps; computing that cache with the CPU's lax.scan
aggregation takes tens of minutes. This renders the exact ate_lab
scene/trajectory (identity rig, supersample=2), runs the production 8-path
bf16 SGM (the CUDA kernel on a GPU), and writes the NPZ ate_lab expects.

Also prints the keypoint-level disparity error stats vs the analytic GT —
the number the BAConfig.sigma_disparity constant is supposed to describe
(feed measured SGM residual stats, not 0.5 px
constants).

Usage: python tools/sgm_cache.py \
           [--frames 32] [--out build/sgm_cache.npz]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from online_3d_reconstruction.config import FeatureConfig, StereoConfig
from online_3d_reconstruction.features.fast import detect_keypoints
from online_3d_reconstruction.io.calibration import identity_rig
from online_3d_reconstruction.io.dataset import SyntheticSequence
from online_3d_reconstruction.io.synthetic import (
    Plateau,
    SyntheticScene,
    make_survey_trajectory,
)
from online_3d_reconstruction.stereo.sgm import sgm_disparity
from online_3d_reconstruction.utils.compile_cache import enable_compile_cache


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--out", default="build/sgm_cache.npz")
    ap.add_argument("--distorted", action="store_true",
                    help="use the BENCH rig: raw distorted render + the "
                         "pipeline's banded rectification before SGM — "
                         "isolates what the rectification chain costs vs "
                         "the identity-rig numbers")
    ap.add_argument("--u8", action="store_true",
                    help="quantize the raw views to uint8 first (the "
                         "pipeline's pack_frame wire format) — the bench's "
                         "SGM sees 1/255-quantized pixels; the f32 caches "
                         "do not")
    args = ap.parse_args()

    h, w, d = 384, 512, 64
    calib = None
    if args.distorted:
        from online_3d_reconstruction.io.calibration import (
            CameraIntrinsics,
            StereoCalibration,
            stereo_rectify,
        )

        cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2,
                               width=w, height=h,
                               dist=(-0.08, 0.01, 3e-4, -3e-4, 0.0))
        calib = StereoCalibration(left=cam, right=cam,
                                  translation=np.array([-0.5, 0.0, 0.0]))
        rig = stereo_rectify(calib)
    else:
        rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2,
                           baseline=0.5, width=w, height=h)
    scene = SyntheticScene(seed=5,
                           plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)],
                           supersample=2)
    poses = make_survey_trajectory(args.frames, altitude=30.0, speed=1.2)
    dataset = SyntheticSequence(scene=scene, rig=rig, poses=poses,
                                prior_translation_sigma=0.15,
                                prior_rotation_sigma=0.01, calib=calib)
    scfg = StereoConfig(height=h, width=w, max_disparity=d, num_paths=8)
    fcfg = FeatureConfig(max_keypoints=512, fast_threshold=5.0)
    rectify = None
    if args.distorted:
        from online_3d_reconstruction.stereo.rectify import (
            rectify_pair,
            vertical_band,
        )

        map_l = jnp.asarray(rig.map_left)
        map_r = jnp.asarray(rig.map_right)
        bl = vertical_band(rig.map_left)
        br = vertical_band(rig.map_right)

        def rectify(lft, rgt):
            return rectify_pair(lft, rgt, map_l, map_r,
                                band_left=bl, band_right=br)

    maps = []
    stats = []
    t_render = t_sgm = 0.0
    for i in range(len(dataset)):
        t0 = time.perf_counter()
        f = dataset[i]
        t_render += time.perf_counter() - t0
        t0 = time.perf_counter()
        left_np, right_np = f.left, f.right
        if args.u8:
            q8 = lambda x: np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)
            left_np = q8(left_np).astype(np.float32) / 255.0
            right_np = q8(right_np).astype(np.float32) / 255.0
        left = jnp.asarray(left_np)
        right = jnp.asarray(right_np)
        if rectify is not None:
            left, right = rectify(left, right)
        dd, _ = sgm_disparity(left, right, scfg)
        dd_np = np.asarray(dd)
        t_sgm += time.perf_counter() - t0
        maps.append(dd_np)

        # keypoint-level disparity error vs analytic GT (the noise actually
        # entering the 3D lifts, as opposed to the dense bad-pixel rate)
        kxy, _, kok = detect_keypoints(
            left, max_keypoints=fcfg.max_keypoints,
            threshold=fcfg.fast_threshold / 255.0, subpixel=True)
        kxy = np.asarray(kxy)[np.asarray(kok)]
        # SyntheticSequence delivers the analytic GT disparity in the
        # precomputed-disparity slot (io/dataset.py:83)
        gtd = np.asarray(f.disparity)
        u = np.clip(np.round(kxy[:, 0]).astype(int), 0, w - 1)
        v = np.clip(np.round(kxy[:, 1]).astype(int), 0, h - 1)
        d_sgm = dd_np[v, u]
        d_gt = gtd[v, u]
        ok = (d_sgm > 0) & (d_gt > 0)
        err = d_sgm[ok] - d_gt[ok]
        stats.append((err.mean(), np.sqrt((err ** 2).mean()),
                      np.abs(err).mean(), ok.sum()))
        print(f"frame {i:3d}: kp disp err mean {err.mean():+.3f} "
              f"rms {np.sqrt((err**2).mean()):.3f} px  (n={ok.sum()})",
              flush=True)

    disp_all = np.stack(maps)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, disparity=disp_all)
    s = np.asarray(stats)
    print(f"\nwrote {args.out}  render {t_render:.1f}s  sgm {t_sgm:.1f}s")
    print(f"keypoint disparity error over {len(dataset)} frames:")
    print(f"  per-frame mean (bias) spread: {s[:, 0].min():+.3f} .. "
          f"{s[:, 0].max():+.3f} px, mean {s[:, 0].mean():+.3f}")
    print(f"  rms: mean {s[:, 1].mean():.3f} px   |err|: {s[:, 2].mean():.3f} px")


if __name__ == "__main__":
    main()
