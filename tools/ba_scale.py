"""BA window scaling: the dense-block Schur solve at W = 8..100 keyframes.

SURVEY.md:424 specifies a sliding 100-keyframe window; the dense-block
distributed Schur design (SURVEY.md:175) only earns its architecture at
large W, where the reduced camera system is a real 6Wx6W Cholesky and the
observation accumulations dominate. This tool measures solve wall time and
GN iterations/s across W, using the slot-major accumulation path
(ba/schur.accumulate_normal_blocks slot_major) that keeps the landmark
accumulations O(N*L) instead of the generic O(N*W*L).

Runs on JAX's default backend (``JAX_PLATFORMS=cpu`` for the CPU); timings
use the amortized in-scan method so dispatch overhead cancels
(utils/roofline.py):

  python tools/ba_scale.py [--json out.json]   (from the repo root)
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from online_3d_reconstruction.ba.schur import solve_ba
    from online_3d_reconstruction.ba.testing import make_synthetic_bundle
    from online_3d_reconstruction.utils import roofline
    from online_3d_reconstruction.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    print(f"backend: {jax.default_backend()}  gn_iters: {args.iters}")
    print(f"{'W':>4} {'L':>5} {'obs':>7} {'solve_ms':>9} {'iters/s':>8} "
          f"{'pose_err':>9}")
    rows = []
    for w in (8, 32, 64, 100):
        l = min(32 * w, 2048)
        k_obs = min(l, 512)  # realistic: K keypoint obs/frame over L >> K
        n_obs = w * k_obs    # slot-major: exactly k_obs per keyframe slot
        problem, gt_poses, _ = make_synthetic_bundle(
            np.random.default_rng(0), w=w, l=l, obs_noise=0.02, n_cap=n_obs,
            obs_per_kf=k_obs)

        def run(eps, p, k_obs=k_obs):
            return solve_ba(p._replace(obs_point=p.obs_point + eps),
                            iters=args.iters, damping=1e-4, huber_delta=0.5,
                            slot_major=k_obs)

        sec = roofline.measure_amortized(
            run, (jnp.float32(0.0), problem), inner=4, max_inner=64)
        poses_ref, _, _ = solve_ba(problem, iters=args.iters, damping=1e-4,
                                   huber_delta=0.5, slot_major=k_obs)
        err = float(jnp.linalg.norm(
            poses_ref[:, :3, 3] - jnp.asarray(gt_poses[:, :3, 3]), axis=-1
        ).mean())
        ips = args.iters / sec if sec == sec and sec > 0 else float("nan")
        print(f"{w:>4} {l:>5} {n_obs:>7} {sec*1e3:>9.2f} {ips:>8.1f} "
              f"{err:>9.4f}")
        rows.append({"w": w, "l": l, "obs": n_obs, "solve_s": sec,
                     "gn_iters_per_s": ips, "mean_pose_err_m": err})

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"backend": jax.default_backend(),
                       "gn_iters": args.iters, "rows": rows}, f, indent=2)
        print("written:", args.json)


if __name__ == "__main__":
    main()
