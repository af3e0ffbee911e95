"""Where does the +0.09 px keypoint disparity bias live? Bias vs distance
to the nearest true disparity edge, from a cached SGM run.

If the bias concentrates within a few px of GT disparity discontinuities it
is SGM foreground fattening leaking past the lift's +-2 px edge gate; if it
is uniform it is a matching/aggregation artifact.

Usage (from the repo root): PYTHONPATH=. python tools/bias_vs_edge.py build/sgm_cache_v.npz
"""
from __future__ import annotations

import sys

import numpy as np

import jax.numpy as jnp

from online_3d_reconstruction.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from online_3d_reconstruction.config import FeatureConfig  # noqa: E402
from online_3d_reconstruction.features.fast import detect_keypoints  # noqa: E402
from online_3d_reconstruction.io.calibration import identity_rig  # noqa: E402
from online_3d_reconstruction.io.dataset import SyntheticSequence  # noqa: E402
from online_3d_reconstruction.io.synthetic import (  # noqa: E402
    Plateau, SyntheticScene, make_survey_trajectory)


def main():
    cache = sys.argv[1] if len(sys.argv) > 1 else "build/sgm_cache_v.npz"
    disp_all = np.load(cache)["disparity"]
    n_frames = min(12, len(disp_all))

    h, w = 384, 512
    rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, baseline=0.5,
                       width=w, height=h)
    scene = SyntheticScene(seed=5,
                           plateaus=[Plateau(-6.0, 6.0, -4.0, 8.0, 8.0)],
                           supersample=2)
    poses = make_survey_trajectory(32, altitude=30.0, speed=1.2)
    dataset = SyntheticSequence(scene=scene, rig=rig, poses=poses,
                                prior_translation_sigma=0.15,
                                prior_rotation_sigma=0.01)

    bins = [(0, 3), (3, 6), (6, 12), (12, 1 << 30)]
    errs = {b: [] for b in bins}
    for i in range(n_frames):
        f = dataset[i]
        gtd = np.asarray(f.disparity)
        dd = disp_all[i]
        kxy, _, kok = detect_keypoints(jnp.asarray(f.left), max_keypoints=512,
                                       threshold=5.0 / 255.0, subpixel=True)
        kxy = np.asarray(kxy)[np.asarray(kok)]
        u = np.clip(np.round(kxy[:, 0]).astype(int), 0, w - 1)
        v = np.clip(np.round(kxy[:, 1]).astype(int), 0, h - 1)

        # distance transform to the nearest GT disparity edge (> 0.75 px jump)
        gx = np.abs(np.diff(gtd, axis=1, prepend=gtd[:, :1]))
        gy = np.abs(np.diff(gtd, axis=0, prepend=gtd[:1]))
        edge = (np.maximum(gx, gy) > 0.75)
        try:
            from scipy.ndimage import distance_transform_edt

            dist = distance_transform_edt(~edge)
        except ImportError:
            # chamfer-ish fallback: iterate a few dilations
            dist = np.full(edge.shape, 99.0)
            cur = edge.copy()
            for r in range(25):
                dist[cur & (dist > r)] = r
                cur = (np.roll(cur, 1, 0) | np.roll(cur, -1, 0)
                       | np.roll(cur, 1, 1) | np.roll(cur, -1, 1))
        d_sgm = dd[v, u]
        d_gt = gtd[v, u]
        d_edge = dist[v, u]
        ok = (d_sgm > 0) & (d_gt > 0)
        err = d_sgm - d_gt
        for lo, hi in bins:
            sel = ok & (d_edge >= lo) & (d_edge < hi)
            errs[(lo, hi)].append(err[sel])

    print(f"{n_frames} frames, bias by distance-to-GT-disparity-edge:")
    for b in bins:
        e = np.concatenate(errs[b])
        print(f"  {b[0]:3d}..{min(b[1], 999):3d} px: n={len(e):5d}  "
              f"mean {e.mean():+.3f}  rms {np.sqrt((e**2).mean()):.3f}")


if __name__ == "__main__":
    main()
