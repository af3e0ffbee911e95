"""Bundle-adjustment problem container + residuals/Jacobians.

The reference refines the keyframe window by minimizing 3D-consistency error
over co-observed features with a sparse CPU solver (SURVEY.md §2.1 C11,
§3.4). Our residual is the camera-frame point consistency

    r_kj = R_k^T (X_j - t_k) - p_kj

for keyframe pose T_k = (R_k, t_k) (world-from-camera), landmark X_j (world),
and observation p_kj (the feature's disparity-lifted camera-frame point).
Jacobians are analytic, with a left-multiplicative pose update
T <- exp([rho, phi]) T (se3.retract):

    d r / d rho = -R^T          d r / d phi = R^T [X]_x
    d r / d X   =  R^T

Everything is a fixed-capacity flat observation list (kf index, landmark
index, point, mask) so the whole solve jits with static shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from online_3d_reconstruction.geometry import se3


class BAProblem(NamedTuple):
    poses: jnp.ndarray       # (W, 4, 4) initial world-from-camera keyframe poses
    landmarks: jnp.ndarray   # (L, 3) initial world landmark positions
    lm_valid: jnp.ndarray    # (L,) bool
    obs_kf: jnp.ndarray      # (N,) int32 keyframe index per observation
    obs_lm: jnp.ndarray      # (N,) int32 landmark index per observation
    obs_point: jnp.ndarray   # (N, 3) float32 observed camera-frame point
    obs_valid: jnp.ndarray   # (N,) bool
    # optional absolute pose priors (flight-log GPS/attitude): the reference
    # composes its visual correction onto the absolute prior each frame
    # (SURVEY.md §3.1); the BA-native equivalent is a weak unary prior
    # residual per keyframe, which bounds dead-reckoning drift the way GPS
    # bounds the reference's. None disables the terms.
    priors: "jnp.ndarray | None" = None       # (W, 4, 4)
    prior_valid: "jnp.ndarray | None" = None  # (W,) bool
    # optional per-observation information, in the observation's own (camera)
    # frame: either (N, 3) per-component diagonal weights 1/sigma^2, or
    # (N, 3, 3) full information matrices Sigma^-1. Stereo-lifted points are
    # strongly anisotropic — sigma_z ~ z^2 * sigma_d / (fx b) can be 25x the
    # lateral sigma_xy ~ z * sigma_px / fx at survey altitude — AND
    # correlated: the z error leaks into camera-frame x,y along the ray
    # direction (x = (u-cx) z / fx), which only the full 3x3 form captures
    # (measured: x-lateral RMS 1.5x the y RMS at image edges purely from
    # that coupling). None = unit weights (the unweighted classical form).
    obs_weight: "jnp.ndarray | None" = None   # (N, 3) or (N, 3, 3)


def prior_residuals(poses: jnp.ndarray, problem: BAProblem
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unary prior residuals per keyframe: (r_pos (W, 3), r_rot (W, 3)).

    r_pos = t_k - t_prior;  r_rot = Log(R_k R_prior^T) (world-frame axis-angle).
    """
    t = poses[:, :3, 3]
    r_pos = t - problem.priors[:, :3, 3]
    rel = jnp.einsum("wij,wkj->wik", poses[:, :3, :3],
                     problem.priors[:, :3, :3],
                     precision=jax.lax.Precision.HIGHEST)  # R_k R_prior^T
    r_rot = jax.vmap(se3.log_so3)(rel)
    ok = problem.prior_valid[:, None]
    return jnp.where(ok, r_pos, 0.0), jnp.where(ok, r_rot, 0.0)


def prior_jacobians(poses: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Jacobians of the prior residuals w.r.t. the left-multiplicative pose
    tangent [rho, phi]:  t' ~= t + rho + phi x t  and  R' ~= exp(phi^) R, so

        d r_pos / d[rho, phi] = [I, -[t]_x]      (3, 6)
        d r_rot / d[rho, phi] ~= [0,  I]         (small-angle)
    """
    w = poses.shape[0]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (w, 3, 3))
    t_hat = se3.hat(poses[:, :3, 3])
    j_pos = jnp.concatenate([eye, -t_hat], axis=-1)       # (W, 3, 6)
    j_rot = jnp.concatenate([jnp.zeros_like(eye), eye], axis=-1)
    return j_pos, j_rot


def gather_obs(poses: jnp.ndarray, landmarks: jnp.ndarray,
               problem: BAProblem) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-observation (rot (N,3,3), t (N,3), x (N,3)) via one-hot matmuls.

    One-hot contractions instead of row gathers (``poses[obs_kf]``),
    chosen for the earlier accelerator target and not yet measured on the
    H100; the indices are always in range by construction.
    """
    w = poses.shape[0]
    l = landmarks.shape[0]
    onehot_kf = (problem.obs_kf[:, None]
                 == jnp.arange(w, dtype=jnp.int32)[None, :]).astype(jnp.float32)
    onehot_lm = (problem.obs_lm[:, None]
                 == jnp.arange(l, dtype=jnp.int32)[None, :]).astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    pose_flat = poses[:, :3, :].reshape(w, 12)
    per_obs = jnp.einsum("nw,wf->nf", onehot_kf, pose_flat,
                         precision=hi).reshape(-1, 3, 4)
    x = jnp.einsum("nl,lj->nj", onehot_lm, landmarks, precision=hi)
    return per_obs[:, :, :3], per_obs[:, :, 3], x


def residuals(poses: jnp.ndarray, landmarks: jnp.ndarray,
              problem: BAProblem) -> jnp.ndarray:
    """(N, 3) residuals r = R^T (X - t) - p (invalid slots zeroed)."""
    rot, t, x = gather_obs(poses, landmarks, problem)
    pred = jnp.einsum("nij,nj->ni", jnp.swapaxes(rot, -1, -2), x - t,
                      precision=jax.lax.Precision.HIGHEST)
    r = pred - problem.obs_point
    return jnp.where(problem.obs_valid[:, None], r, 0.0)


def jacobians(poses: jnp.ndarray, landmarks: jnp.ndarray,
              problem: BAProblem) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Analytic per-observation Jacobians.

    Returns (j_pose (N, 3, 6), j_point (N, 3, 3)). Ordering of the pose
    tangent matches se3.exp: [rho (translation), phi (rotation)].
    """
    rot, _, x = gather_obs(poses, landmarks, problem)
    rot_t = jnp.swapaxes(rot, -1, -2)            # (N, 3, 3) = R^T
    x_hat = se3.hat(x)                           # (N, 3, 3)
    j_rho = -rot_t
    j_phi = jnp.einsum("nij,njk->nik", rot_t, x_hat,
                       precision=jax.lax.Precision.HIGHEST)
    j_pose = jnp.concatenate([j_rho, j_phi], axis=-1)    # (N, 3, 6)
    j_point = rot_t
    mask = problem.obs_valid[:, None, None]
    return jnp.where(mask, j_pose, 0.0), jnp.where(mask, j_point, 0.0)


def weighted_sqnorm(r: jnp.ndarray, problem: BAProblem) -> jnp.ndarray:
    """(N,) squared residual norm in whitened units: r^T W r.

    With ``obs_weight`` set ((N, 3) diagonal or (N, 3, 3) full information)
    this is dimensionless (sigma units); without it plain |r|^2 in metres^2 —
    the classical isotropic form.
    """
    if problem.obs_weight is None:
        return jnp.sum(r * r, axis=-1)
    if problem.obs_weight.ndim == 3:
        # matvec + elementwise dot, NOT the fused "ni,nij,nj->n" quadratic
        # form, which can lower to a padded batched tiny matmul
        # (chosen for the earlier accelerator target; not yet measured on the H100)
        wr = jnp.einsum("nij,nj->ni", problem.obs_weight, r,
                        precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(r * wr, axis=-1)
    return jnp.sum(problem.obs_weight * r * r, axis=-1)


def stereo_obs_weights(points: jnp.ndarray, depth_coeff: float,
                       lateral_coeff: float, min_depth: float = 1.0
                       ) -> jnp.ndarray:
    """(N, 3) DIAGONAL information weights from the stereo noise model.

    For a camera-frame point at depth z from a rectified pair with focal fx
    and baseline b:  sigma_z = z^2 * sigma_d / (fx b) (disparity noise
    sigma_d), sigma_x = sigma_y = z * sigma_px / fx (localization noise
    sigma_px). Callers pass depth_coeff = sigma_d / (fx b) and
    lateral_coeff = sigma_px / fx; weights are 1/sigma^2 per component.
    Legacy diagonal model — it ignores the ray-direction x/y<->z coupling;
    prefer ``stereo_obs_information``.
    """
    z = jnp.maximum(jnp.abs(points[..., 2]), min_depth)
    w_lat = 1.0 / (lateral_coeff * z) ** 2
    w_z = 1.0 / (depth_coeff * z * z) ** 2
    return jnp.stack([w_lat, w_lat, w_z], axis=-1)


class StereoNoiseModel(NamedTuple):
    """Static (hashable) stereo measurement-noise description.

    The pipeline builds one from the rig + BAConfig sigmas; it rides through
    the jitted keyframe step as a static argument.
    """

    fx: float
    fy: float
    baseline: float
    sigma_px: float         # 1-sigma keypoint localization noise (pixels)
    sigma_disparity: float  # 1-sigma disparity noise (pixels)


def stereo_obs_information(points: jnp.ndarray, model: StereoNoiseModel,
                           min_depth: float = 1.0) -> jnp.ndarray:
    """(N, 3, 3) FULL information matrices Sigma^-1 per observation.

    The stereo lift p = ((u-cx) z / fx, (v-cy) z / fy, z) with z = fx b / d
    maps independent pixel-space noise (sigma_u, sigma_v, sigma_d) through
    the Jacobian J = d p / d (u, v, d); Sigma = J diag(sigma^2) J^T. Its
    inverse is closed-form because J is triangular:

        J^-1 = [[fx/z, 0, -fx x / z^2],
                [0, fy/z, -fy y / z^2],
                [0, 0,    -fx b / z^2]]

    so with M = diag(1/sigma) J^-1, the information is W = M^T M. Unlike the
    diagonal model (``stereo_obs_weights``) this captures the x/y<->z
    coupling along the ray: at the image edge (|u-cx| ~ 0.6 fx) the z error
    contributes ~0.6 sigma_z to camera-frame x, which measurably dominates
    the lateral residual there.
    """
    x = points[..., 0]
    y = points[..., 1]
    z = jnp.maximum(jnp.abs(points[..., 2]), min_depth)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    r1 = jnp.stack([model.fx * inv_z / model.sigma_px,
                    jnp.zeros_like(z),
                    -model.fx * x * inv_z2 / model.sigma_px], axis=-1)
    r2 = jnp.stack([jnp.zeros_like(z),
                    model.fy * inv_z / model.sigma_px,
                    -model.fy * y * inv_z2 / model.sigma_px], axis=-1)
    r3 = jnp.stack([jnp.zeros_like(z),
                    jnp.zeros_like(z),
                    -model.fx * model.baseline * inv_z2
                    / model.sigma_disparity], axis=-1)
    m = jnp.stack([r1, r2, r3], axis=-2)          # (N, 3, 3)
    # HIGHEST: a reduced-precision default (TF32 on the GPU) would quantize
    # the information weights (values ~1e2-1e3) enough to corrupt the GN
    # cost comparison
    return jnp.einsum("nki,nkj->nij", m, m,
                      precision=jax.lax.Precision.HIGHEST)  # M^T M


def total_cost(poses: jnp.ndarray, landmarks: jnp.ndarray,
               problem: BAProblem, huber_delta: float = 0.0) -> jnp.ndarray:
    """Scalar robust cost (0.5 sum rho(|r|_W^2)); huber_delta<=0 = pure L2.

    The norm is the whitened one when the problem carries ``obs_weight``
    (huber_delta is then in sigma units), else metres.
    """
    r = residuals(poses, landmarks, problem)
    sq = weighted_sqnorm(r, problem)
    if huber_delta > 0:
        norm = jnp.sqrt(jnp.maximum(sq, 1e-18))
        lin = huber_delta * (2.0 * norm - huber_delta)
        cost = jnp.where(norm <= huber_delta, sq, lin)
    else:
        cost = sq
    return 0.5 * jnp.sum(jnp.where(problem.obs_valid, cost, 0.0))


def huber_weights(r: jnp.ndarray, delta: float,
                  problem: "BAProblem | None" = None) -> jnp.ndarray:
    """(N,) IRLS weights for the Huber loss on the (whitened) residual norm."""
    if problem is not None:
        norm = jnp.sqrt(jnp.maximum(weighted_sqnorm(r, problem), 1e-24))
    else:
        norm = jnp.linalg.norm(r, axis=-1)
    return jnp.where(norm <= delta, 1.0, delta / jnp.maximum(norm, 1e-12))
