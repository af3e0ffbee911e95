"""Rigid 3D-3D alignment: weighted Umeyama fit + fixed-shape RANSAC.

The reference lifts matched keypoints to 3D via their disparities and fits a
rigid SE(3) with a centroid+SVD estimate plus outlier gating (SURVEY.md §2.1
C9, §3.3). Accelerator form: the SVD fit is a tiny fp32 batch op; RANSAC runs
a *fixed* number of hypotheses as one ``vmap`` (3-point minimal fits in
parallel), scores all of them against all matches in one broadcast, and
refits on the best inlier set — no data-dependent iteration, identical cost
every frame.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from online_3d_reconstruction.geometry import se3


def rigid_transform(src: jnp.ndarray, dst: jnp.ndarray,
                    weights: jnp.ndarray) -> jnp.ndarray:
    """Weighted least-squares rigid fit: find T with dst ~= R @ src + t.

    src, dst: (N, 3); weights: (N,) nonnegative. Returns (4, 4) float32.
    Degenerate inputs (rank-deficient covariance) still return a valid
    rotation (SVD is total); callers gate on inlier fitness, not on here.
    """
    w = weights.astype(jnp.float32)
    w_sum = jnp.maximum(jnp.sum(w), 1e-9)
    wn = (w / w_sum)[:, None]
    centroid_s = jnp.sum(src * wn, axis=0)
    centroid_d = jnp.sum(dst * wn, axis=0)
    src_c = src - centroid_s
    dst_c = dst - centroid_d
    # 3x3 weighted cross-covariance at full precision (pose math, never matmul-bound)
    cov = jnp.einsum("ni,nj->ij", src_c * wn, dst_c,
                     precision=jax.lax.Precision.HIGHEST)
    u, _, vt = jnp.linalg.svd(cov)
    # HIGHEST precision on every product: these 3x3 matmuls ran at the
    # earlier target's bf16 default for four rounds — a 2^-8 relative
    # rotation error is ~4e-3 rad, which the planar-scene tilt degeneracy
    # converts to ~0.1 m of lateral link error at 30 m altitude (measured:
    # identical cached inputs scored full-stack ATE 0.47x prior on CPU but
    # 0.54x on that accelerator before this fix). TF32, the GPU's reduced
    # default, would do the same.
    hi = jax.lax.Precision.HIGHEST
    mm = lambda x, y: jnp.matmul(x, y, precision=hi)
    det = jnp.linalg.det(mm(vt.T, u.T))
    d_fix = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(jnp.sign(det))
    rot = mm(mm(vt.T, d_fix), u.T)
    t = centroid_d - mm(rot, centroid_s[:, None])[:, 0]
    return se3.from_rt(rot.astype(jnp.float32), t.astype(jnp.float32))


def refine_rigid_gn(
    t_init: jnp.ndarray,
    src: jnp.ndarray,
    dst: jnp.ndarray,
    weights: jnp.ndarray,
    comp_weight: jnp.ndarray,
    rot_prior: "jnp.ndarray | None" = None,
    rot_prior_weight: float = 0.0,
    iters: int = 3,
    damping: float = 1e-6,
) -> jnp.ndarray:
    """Gauss-Newton polish of a rigid link fit with a rotation prior.

    Minimizes  sum_i w_i |C^(1/2) (T(s_i) - d_i)|^2
             + rot_prior_weight * |Log(R R_prior^T)|^2
    over the se3 tangent (left-multiplicative update). Two failure modes of
    the plain Umeyama/IRLS link fit this addresses (measured on the bench
    scene, tools/vo_link_err + per-link on-accelerator diagnosis):

    - TILT-TRANSLATION DEGENERACY: over a near-planar nadir scene a tilt
      error delta_phi is almost indistinguishable from a lateral shift
      z * delta_phi (~0.1 m/link at 30 m altitude); the flight-log attitude
      prior (the reference composes it the same way, SURVEY.md §3.3) is
      exactly the missing tilt information.
    - ANISOTROPIC NOISE: stereo z errors are ~3x the lateral ones and
      correlated; ``comp_weight`` (camera-frame per-component information,
      e.g. (1, 1, 0.1)) stops them from steering the lateral/tilt estimate.
    """
    comp = comp_weight.astype(jnp.float32)

    def step(t_cur, _):
        p = se3.transform_points(t_cur, src)             # (N, 3)
        r = p - dst
        w = weights.astype(jnp.float32)
        # J_i = [I | -hat(p_i)] for r_i = exp(xi) T s_i - d_i
        hi = jax.lax.Precision.HIGHEST
        eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                               (src.shape[0], 3, 3))
        j = jnp.concatenate([eye, -se3.hat(p)], axis=-1)  # (N, 3, 6)
        jw = j * (w[:, None, None] * comp[None, :, None])
        h = jnp.einsum("nij,nik->jk", jw, j, precision=hi)
        g = jnp.einsum("nij,ni->j", jw, r, precision=hi)
        if rot_prior is not None and rot_prior_weight > 0:
            r_rot = se3.log_so3(
                jnp.matmul(t_cur[:3, :3], rot_prior.T,
                           precision=hi))
            h = h.at[3:, 3:].add(rot_prior_weight * jnp.eye(3))
            g = g.at[3:].add(rot_prior_weight * r_rot)
        h = h + damping * jnp.eye(6, dtype=jnp.float32)
        delta = -jnp.linalg.solve(h, g)
        return se3.retract(t_cur, delta), None

    t_out, _ = jax.lax.scan(step, t_init, None, length=iters)
    return t_out


@partial(jax.jit, static_argnames=("iters", "threshold", "min_inliers",
                                   "rot_prior_weight", "depth_rel_weight"))
def ransac_rigid(
    src: jnp.ndarray,
    dst: jnp.ndarray,
    valid: jnp.ndarray,
    key: jax.Array,
    iters: int = 128,
    threshold: float = 0.25,
    min_inliers: int = 12,
    weights: jnp.ndarray = None,
    rot_prior: "jnp.ndarray | None" = None,
    rot_prior_weight: float = 0.0,
    depth_rel_weight: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Robust rigid fit of dst ~= T(src) over masked correspondences.

    ``weights`` (optional, (N,)): relative confidence per pair — e.g.
    1/4^octave for pyramid keypoints, whose localization variance grows with
    the level. Weights scale the least-squares fits; inlier *counting* stays
    unweighted so the fitness gate keeps its meaning.

    ``rot_prior`` (3, 3) + ``rot_prior_weight`` and ``depth_rel_weight``
    feed the final GN polish (``refine_rigid_gn``): the flight-log relative
    attitude regularizes the tilt modes a planar scene cannot constrain, and
    the z residual component is down-weighted to its stereo information.

    Returns (T (4,4), inlier_mask (N,), inlier_count (), ok ()).
    ``ok`` is False when the best hypothesis has < min_inliers — the caller
    falls back to its pose prior (the reference's fitness gate).
    """
    n = src.shape[0]
    if weights is None:
        weights = jnp.ones(n, dtype=jnp.float32)

    # --- hypothesis sampling: (iters, 3) indices over the match slots -------
    samples = jax.random.randint(key, (iters, 3), 0, n)

    def fit_minimal(idx):
        # Closed-form triad alignment instead of the Umeyama SVD: batched
        # 3x3 jnp.linalg.svd lowered near-serially on the earlier
        # accelerator target (the same class as the batched linalg.inv the
        # Schur solver dropped; not yet measured on the H100), and a RANSAC
        # HYPOTHESIS only needs to be exact for its own 3 support points —
        # scoring against all matches and the SVD/IRLS refit decide the
        # pose. Build an orthonormal frame from the two edge vectors on
        # each side; R maps one frame onto the other.
        s = src[idx]
        d = dst[idx]
        # all three points must be valid, else the hypothesis scores 0
        # inliers; degenerate (collinear) triples produce garbage R and are
        # likewise out-scored, exactly as a degenerate SVD fit was
        w_ok = jnp.all(valid[idx])

        def triad(p):
            e1 = p[1] - p[0]
            e2 = p[2] - p[0]
            b1 = e1 / jnp.maximum(jnp.linalg.norm(e1), 1e-9)
            c = jnp.cross(e1, e2)
            b3 = c / jnp.maximum(jnp.linalg.norm(c), 1e-9)
            b2 = jnp.cross(b3, b1)
            return jnp.stack([b1, b2, b3], axis=1)     # columns (3, 3)

        ts = triad(s)
        td = triad(d)
        rot = jnp.matmul(td, ts.T, precision=jax.lax.Precision.HIGHEST)
        cen_s = jnp.mean(s, axis=0)
        cen_d = jnp.mean(d, axis=0)
        t = cen_d - jnp.matmul(rot, cen_s[:, None],
                               precision=jax.lax.Precision.HIGHEST)[:, 0]
        return se3.from_rt(rot, t), w_ok

    t_hyp, hyp_ok = jax.vmap(fit_minimal)(samples)  # (iters, 4, 4), (iters,)

    # --- score every hypothesis against every match in one broadcast -------
    src_h = jnp.concatenate([src, jnp.ones((n, 1), dtype=src.dtype)], axis=1)
    proj = jnp.einsum("kij,nj->kni", t_hyp, src_h,
                      precision=jax.lax.Precision.HIGHEST)[..., :3]
    err = jnp.linalg.norm(proj - dst[None], axis=-1)  # (iters, N)
    inlier = (err < threshold) & valid[None]
    counts = jnp.sum(inlier, axis=1) * hyp_ok.astype(jnp.int32)

    best = jnp.argmax(counts)
    best_mask = inlier[best]

    # --- refit on inliers, then IRLS polish with Huber weights --------------
    # A hard inlier ball truncates the residual distribution and biases the
    # refit when noise sigma ~ threshold; 3 Huber reweighting steps over the
    # *full* match set (anchored by the RANSAC consensus) fix that.
    t_fit = rigid_transform(src, dst, best_mask.astype(jnp.float32) * weights)
    huber = threshold

    def irls_step(t_cur, _):
        r = jnp.linalg.norm(se3.transform_points(t_cur, src) - dst, axis=-1)
        w = jnp.where(r <= huber, 1.0, huber / jnp.maximum(r, 1e-9))
        w = w * valid.astype(jnp.float32) * weights
        return rigid_transform(src, dst, w), None

    t_fit, _ = jax.lax.scan(irls_step, t_fit, None, length=3)

    # final polish: anisotropic component weights + rotation prior (the
    # tilt-degeneracy fix; see refine_rigid_gn) on the Huber-weighted set
    r_fin = jnp.linalg.norm(se3.transform_points(t_fit, src) - dst, axis=-1)
    w_fin = jnp.where(r_fin <= huber, 1.0, huber / jnp.maximum(r_fin, 1e-9))
    w_fin = w_fin * valid.astype(jnp.float32) * weights
    comp = jnp.array([1.0, 1.0, depth_rel_weight], jnp.float32)
    t_fit = refine_rigid_gn(t_fit, src, dst, w_fin, comp,
                            rot_prior=rot_prior,
                            rot_prior_weight=rot_prior_weight)

    proj = se3.transform_points(t_fit, src)
    refined_mask = (jnp.linalg.norm(proj - dst, axis=-1) < threshold) & valid
    count = jnp.sum(refined_mask)
    ok = count >= min_inliers
    t_out = jnp.where(ok, t_fit, jnp.eye(4, dtype=jnp.float32))
    return t_out, refined_mask, count, ok
