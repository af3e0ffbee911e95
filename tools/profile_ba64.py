"""Piecewise device timing of the W=64 slot-major Schur solve.

This splits one GN iteration of the bench's ba_schur_w64 solve into its
parts so the dominant term is a measurement, not a guess:

- residuals+jacobians (the (N, L)/(N, W) one-hot gathers),
- the slot-major accumulation scan,
- schur_solve (EC^-1, S assembly, 384x384 Cholesky, back-substitution),
- total_cost (the step's two cost-guard evaluations re-run the full
  residual pass).

Usage: python tools/profile_ba64.py   (from the repo root)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.ba.problem import (
    jacobians,
    residuals,
    total_cost,
)
from online_3d_reconstruction.ba.schur import (
    accumulate_normal_blocks,
    schur_solve,
    solve_ba,
)
from online_3d_reconstruction.ba.testing import make_synthetic_bundle
from online_3d_reconstruction.utils.roofline import measure_amortized


from online_3d_reconstruction.utils.compile_cache import enable_compile_cache  # noqa: E402

def main():
    enable_compile_cache()
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=64)
    ap.add_argument("--l", type=int, default=2048)
    ap.add_argument("--k", type=int, default=512)
    args = ap.parse_args()
    print("backend:", jax.default_backend(),
          f"W={args.w} L={args.l} K={args.k}", flush=True)
    w64, l64, k64 = args.w, args.l, args.k
    problem, _, _ = make_synthetic_bundle(
        np.random.default_rng(2), w=w64, l=l64, obs_noise=0.02,
        n_cap=w64 * k64, obs_per_kf=k64)
    poses = problem.poses
    lms = problem.landmarks
    huber = 0.5

    rows = []

    def report(name, sec):
        rows.append((name, sec))
        print(f"{name:44s} {sec * 1e3:8.3f} ms", flush=True)

    sec = measure_amortized(
        lambda eps, p: residuals(poses, lms + eps, p),
        (jnp.float32(0.0), problem), inner=16)
    report("residuals (one pass)", sec)

    sec = measure_amortized(
        lambda eps, p: jacobians(poses, lms + eps, p),
        (jnp.float32(0.0), problem), inner=16)
    report("jacobians (one pass)", sec)

    sec = measure_amortized(
        lambda eps, p: total_cost(poses, lms + eps, p, huber),
        (jnp.float32(0.0), problem), inner=16)
    report("total_cost (one eval)", sec)

    sec = measure_amortized(
        lambda eps, p: accumulate_normal_blocks(
            poses, lms + eps, p, huber, slot_major=k64),
        (jnp.float32(0.0), problem), inner=8)
    report("accumulate slot-major (incl res+jac)", sec)

    blocks = accumulate_normal_blocks(poses, lms, problem, huber,
                                      slot_major=k64)

    sec = measure_amortized(
        lambda eps, b, c, e, gp, gx: schur_solve(
            b + eps, c, e, gp, gx, 1e-4, True),
        (jnp.float32(0.0),) + tuple(blocks), inner=8)
    report("schur_solve (inv+EC+S+chol+backsub)", sec)

    b, c, e, gp, gx = blocks

    from online_3d_reconstruction.ba.schur import inv3x3

    sec = measure_amortized(
        lambda eps, cc: inv3x3(
            cc + eps + 1e-4 * jnp.eye(3, dtype=jnp.float32)[None]),
        (jnp.float32(0.0), c), inner=16)
    report(f"  C^-1 ({l64} adjugate 3x3 inv)", sec)

    c_inv = inv3x3(c + 1e-4 * jnp.eye(3, dtype=jnp.float32)[None])
    hi = jax.lax.Precision.HIGHEST

    sec = measure_amortized(
        lambda eps, ee: jnp.einsum("wlij,ljk->wlik", ee + eps, c_inv,
                                   precision=hi),
        (jnp.float32(0.0), e), inner=8)
    report("  EC^-1 einsum", sec)

    ec = jnp.einsum("wlij,ljk->wlik", e, c_inv, precision=hi)

    sec = measure_amortized(
        lambda eps, ee: jnp.einsum("aljk,blmk->ajbm", ec + eps, ee,
                                   precision=hi),
        (jnp.float32(0.0), e), inner=8)
    report("  S coupling einsum (W^2 L 6 6 3)", sec)

    s_full = jnp.eye(w64 * 6, dtype=jnp.float32) * 100.0

    sec = measure_amortized(
        lambda eps, s: jax.scipy.linalg.cho_factor(s + eps)[0],
        (jnp.float32(0.0), s_full), inner=16)
    report("  cho_factor 384x384", sec)

    chol = jax.scipy.linalg.cho_factor(s_full)

    sec = measure_amortized(
        lambda eps, r: jax.scipy.linalg.cho_solve(chol, r + eps),
        (jnp.float32(0.0), gp.reshape(-1)), inner=16)
    report("  cho_solve 384", sec)

    sec = measure_amortized(
        lambda eps, p: solve_ba(p._replace(obs_point=p.obs_point + eps),
                                iters=1, damping=1e-4, huber_delta=huber,
                                slot_major=k64),
        (jnp.float32(0.0), problem), inner=8)
    report("solve_ba 1 iter (2 cost evals + acc + solve)", sec)

    sec = measure_amortized(
        lambda eps, p: solve_ba(p._replace(obs_point=p.obs_point + eps),
                                iters=5, damping=1e-4, huber_delta=huber,
                                slot_major=k64),
        (jnp.float32(0.0), problem), inner=4, max_inner=32)
    report("solve_ba 5 iters (the bench kernel)", sec)

    # the pipeline's actual solve shape: full 3x3 obs information + priors
    from online_3d_reconstruction.ba.problem import (
        StereoNoiseModel,
        stereo_obs_information,
    )

    nm = StereoNoiseModel(fx=400.0, fy=400.0, baseline=0.5, sigma_px=0.5,
                          sigma_disparity=1.0)
    info = stereo_obs_information(problem.obs_point, nm)
    pw = problem._replace(
        obs_weight=info, priors=problem.poses,
        prior_valid=jnp.ones(w64, bool))
    sec = measure_amortized(
        lambda eps, p: solve_ba(p._replace(obs_point=p.obs_point + eps),
                                iters=5, damping=1e-4, huber_delta=3.0,
                                anchor_first=False,
                                prior_position_weight=44.4,
                                prior_rotation_weight=1e4,
                                slot_major=k64),
        (jnp.float32(0.0), pw), inner=4, max_inner=32)
    report("solve_ba 5 it (3x3 info + priors, in-situ)", sec)

    # decompose the in-situ overhead: weights alone vs priors alone
    sec = measure_amortized(
        lambda eps, p: solve_ba(p._replace(obs_point=p.obs_point + eps),
                                iters=5, damping=1e-4, huber_delta=3.0,
                                slot_major=k64),
        (jnp.float32(0.0), problem._replace(obs_weight=info)),
        inner=4, max_inner=32)
    report("solve_ba 5 it (3x3 info only)", sec)

    sec = measure_amortized(
        lambda eps, p: solve_ba(p._replace(obs_point=p.obs_point + eps),
                                iters=5, damping=1e-4, huber_delta=huber,
                                anchor_first=False,
                                prior_position_weight=44.4,
                                prior_rotation_weight=1e4,
                                slot_major=k64),
        (jnp.float32(0.0),
         problem._replace(priors=problem.poses,
                          prior_valid=jnp.ones(w64, bool))),
        inner=4, max_inner=32)
    report("solve_ba 5 it (priors only)", sec)


if __name__ == "__main__":
    main()
