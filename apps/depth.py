#!/usr/bin/env python
"""Standalone stereo-depth tool — driver config [B:7] / SURVEY.md §3.6
``o3r.stereo.depth``: one rectified pair -> disparity (+ optional cloud).

  python apps/depth.py --left l.npy --right r.npy --calib calib.json \
      --output out/ [--cloud] [--set stereo.max_disparity=128]
  python apps/depth.py --synthetic --output out/      # oracle self-test
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--left")
    p.add_argument("--right")
    p.add_argument("--calib", help="calibration JSON (omit if pre-rectified)")
    p.add_argument("--synthetic", action="store_true",
                   help="use a rendered synthetic pair + report GT error")
    p.add_argument("--output", default="out")
    p.add_argument("--cloud", action="store_true", help="also write cloud.ply")
    p.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL")
    args = p.parse_args(argv)
    from online_3d_reconstruction.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(args.output, exist_ok=True)

    import jax.numpy as jnp

    from online_3d_reconstruction.config import load_config
    from online_3d_reconstruction.geometry.backproject import backproject_disparity
    from online_3d_reconstruction.io.calibration import (
        identity_rig,
        load_calibration_json,
        stereo_rectify,
    )
    from online_3d_reconstruction.stereo.rectify import rectify_pair
    from online_3d_reconstruction.stereo.sgm import sgm_disparity

    overrides = {}
    for item in args.set:
        key, _, val = item.partition("=")
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val
    cfg = load_config(None, overrides)

    gt = None
    if args.synthetic:
        from online_3d_reconstruction.io.synthetic import (
            Plateau,
            SyntheticScene,
            nadir_pose,
        )

        h, w = cfg.stereo.height, cfg.stereo.width
        rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2,
                           baseline=0.5, width=w, height=h)
        scene = SyntheticScene(seed=5, plateaus=[Plateau(-6, 6, -4, 8, 8.0)])
        frame = scene.render_stereo(nadir_pose(0, 0, 30.0), rig)
        left, right, color = frame.left, frame.right, frame.left_rgb
        gt = frame.gt_disparity
    else:
        if not (args.left and args.right):
            raise SystemExit("need --left/--right or --synthetic")
        from online_3d_reconstruction.io.dataset import ImageFolderSequence

        left = ImageFolderSequence._load_image(args.left)
        right = ImageFolderSequence._load_image(args.right)
        if left.ndim == 3:
            color, left = left, left.mean(axis=-1)
            right = right.mean(axis=-1) if right.ndim == 3 else right
        else:
            color = np.repeat(left[..., None], 3, axis=-1)
        if args.calib:
            rig = stereo_rectify(load_calibration_json(args.calib))
        else:
            h, w = left.shape
            rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2,
                               baseline=0.5, width=w, height=h)

    left_j = jnp.asarray(left)
    right_j = jnp.asarray(right)
    if args.calib:
        left_j, right_j = rectify_pair(
            left_j, right_j, jnp.asarray(rig.map_left), jnp.asarray(rig.map_right)
        )
    disp, valid = sgm_disparity(left_j, right_j, cfg.stereo)
    disp_np = np.asarray(disp)
    np.save(os.path.join(args.output, "disparity.npy"), disp_np)

    msg = {
        "valid_fraction": float(np.asarray(valid).mean()),
        "disparity_range": [float(disp_np[np.asarray(valid)].min()) if np.asarray(valid).any() else 0.0,
                            float(disp_np.max())],
    }
    if gt is not None:
        m = np.asarray(valid) & np.isfinite(gt)
        msg["bad_gt_1px"] = float((np.abs(disp_np[m] - gt[m]) > 1.0).mean())
    if args.cloud:
        from online_3d_reconstruction.io.export import save_ply

        q = jnp.asarray(rig.q, dtype=jnp.float32)
        cloud = backproject_disparity(disp, jnp.asarray(color), q,
                                      stride=cfg.mapping.frame_point_stride,
                                      min_depth=cfg.mapping.min_depth,
                                      max_depth=cfg.mapping.max_depth)
        ok = np.asarray(cloud.valid)
        save_ply(os.path.join(args.output, "cloud.ply"),
                 np.asarray(cloud.points)[ok], np.asarray(cloud.colors)[ok])
        msg["cloud_points"] = int(ok.sum())
    print(json.dumps(msg), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
