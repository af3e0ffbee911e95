#!/usr/bin/env python
"""Standalone bundle-adjustment tool — driver config [B:9] / SURVEY.md §3.6
``o3r.ba.solve``: solve a window problem from a file, or run the synthetic
self-benchmark (GN convergence + iters/s).

  python apps/ba_solve.py --selftest [--window 8 --landmarks 256]
  python apps/ba_solve.py --problem problem.npz [--sharded N]

problem.npz schema: poses (W,4,4), landmarks (L,3), lm_valid (L,),
obs_kf (N,), obs_lm (N,), obs_point (N,3), obs_valid (N,).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--problem", help="npz bundle problem (see schema above)")
    p.add_argument("--selftest", action="store_true",
                   help="synthetic bundle with known optimum")
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--landmarks", type=int, default=256)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--damping", type=float, default=1e-4)
    p.add_argument("--huber", type=float, default=0.5)
    p.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="solve observation-sharded over an N-device mesh")
    p.add_argument("--output", help="write refined poses npz here")
    args = p.parse_args(argv)
    from online_3d_reconstruction.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from online_3d_reconstruction.ba.problem import BAProblem
    from online_3d_reconstruction.ba.schur import solve_ba
    from online_3d_reconstruction.ba.testing import make_synthetic_bundle
    from online_3d_reconstruction.geometry import se3

    if args.selftest:
        problem, gt_poses, _ = make_synthetic_bundle(
            np.random.default_rng(0), w=args.window, l=args.landmarks,
            pose_noise=0.08, obs_noise=0.02,
        )
    elif args.problem:
        with np.load(args.problem) as z:
            problem = BAProblem(**{k: jnp.asarray(z[k]) for k in (
                "poses", "landmarks", "lm_valid", "obs_kf", "obs_lm",
                "obs_point", "obs_valid")})
        gt_poses = None
    else:
        raise SystemExit("need --problem or --selftest")

    if args.sharded:
        from online_3d_reconstruction.parallel import make_mesh, solve_ba_sharded

        mesh = make_mesh(args.sharded)
        solver = lambda pr: solve_ba_sharded(  # noqa: E731
            pr, mesh, iters=args.iters, damping=args.damping,
            huber_delta=args.huber)
    else:
        solver = lambda pr: solve_ba(  # noqa: E731
            pr, iters=args.iters, damping=args.damping, huber_delta=args.huber)

    poses, landmarks, trace = solver(problem)   # warm/compile
    jax.block_until_ready(poses)
    t0 = time.perf_counter()
    poses, landmarks, trace = solver(problem)
    jax.block_until_ready(poses)
    dt = time.perf_counter() - t0

    msg = {
        "cost_trace": [float(c) for c in np.asarray(trace)],
        "gn_iters_per_s": args.iters / dt,
        "solve_ms": dt * 1e3,
    }
    if gt_poses is not None:
        errs = [
            float(se3.geodesic_distance(jnp.asarray(gt_poses[k]), poses[k])[0])
            for k in range(len(gt_poses))
        ]
        msg["mean_pose_error_m"] = float(np.mean(errs))
    if args.output:
        np.savez(args.output, poses=np.asarray(poses),
                 landmarks=np.asarray(landmarks))
    print(json.dumps(msg))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
