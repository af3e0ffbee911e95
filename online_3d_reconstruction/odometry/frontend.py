"""Visual-odometry front-end: features -> matches -> 3D-3D pose correction.

Mirrors the reference's pose-correction path (SURVEY.md §3.3): ORB detect on
the left image, brute-force match against the previous keyframe, lift both
matched sets to 3D through their disparity maps, estimate the rigid relative
transform, gate on fitness, and compose with the flight-log prior. Every
stage here is the accelerator counterpart (stencil FAST, matmul matching,
vmapped RANSAC), fused into one jitted step per frame.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from online_3d_reconstruction.config import FeatureConfig, MatchConfig, OdometryConfig
from online_3d_reconstruction.features.brief import Keypoints, detect_and_describe
from online_3d_reconstruction.features.match import match_descriptors
from online_3d_reconstruction.geometry import se3
from online_3d_reconstruction.odometry.rigid import ransac_rigid


class FrameFeatures(NamedTuple):
    """Per-frame odometry state: keypoints + their camera-frame 3D lifts."""

    keypoints: Keypoints
    points3d: jnp.ndarray   # (K, 3) float32 camera-frame points
    valid3d: jnp.ndarray    # (K,) bool — keypoint has a usable depth


def lift_keypoints_to_3d(
    xy: jnp.ndarray,
    disparity: jnp.ndarray,
    q: jnp.ndarray,
    max_depth: float = 80.0,
    min_depth: float = 0.1,
    edge_threshold: float = 1.5,
    smooth_radius: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lift (K, 2) pixel coords to camera-frame 3D via the disparity map.

    Samples each keypoint's disparity bilinearly (subpixel keypoints deserve
    subpixel disparity) and applies Q, the same per-point math as the dense
    backprojection (geometry/backproject.py). Falls back to the nearest pixel
    when any bilinear corner is invalid — averaging across a validity
    boundary would mix surfaces.

    Corners cluster on object boundaries, where SGM disparity mixes the two
    surfaces and systematically biases the 3D-3D fit; keypoints whose 4
    (2px-spaced) neighbors disagree by more than ``edge_threshold`` pixels of
    disparity (or are invalid) are rejected. Returns ((K, 3) points, (K,) valid).

    ``smooth_radius`` r > 0 pre-averages the disparity over a valid-masked
    (2r+1)^2 box before sampling: a point sample carries the full per-pixel
    SGM noise into every observation, while the local mean respects a smooth
    surface (the terrain is near fronto-parallel at nadir) and cuts the
    z-noise feeding both the link fits and the BA. The edge rejection below
    still uses the RAW map so discontinuities keep their sharp veto.
    """
    h, w = disparity.shape
    u = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, w - 1)
    v = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, h - 1)
    raw = disparity
    if smooth_radius > 0:
        win = 2 * smooth_radius + 1
        ok_px = (disparity > 0).astype(jnp.float32)
        num = jax.lax.reduce_window(disparity * ok_px, 0.0, jax.lax.add,
                                    (win, win), (1, 1), "SAME")
        den = jax.lax.reduce_window(ok_px, 0.0, jax.lax.add,
                                    (win, win), (1, 1), "SAME")
        smoothed = num / jnp.maximum(den, 1.0)
        disparity = jnp.where((den > 0) & (disparity > 0), smoothed,
                              disparity)
    d_nearest = disparity[v, u]

    xf = jnp.clip(xy[:, 0], 0.0, w - 1.0)
    yf = jnp.clip(xy[:, 1], 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(xf).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(yf).astype(jnp.int32), 0, h - 2)
    tx = xf - x0.astype(jnp.float32)
    ty = yf - y0.astype(jnp.float32)
    d00 = disparity[y0, x0]
    d10 = disparity[y0, x0 + 1]
    d01 = disparity[y0 + 1, x0]
    d11 = disparity[y0 + 1, x0 + 1]
    corners_ok = (d00 > 0) & (d10 > 0) & (d01 > 0) & (d11 > 0)
    d_bilin = ((1 - ty) * ((1 - tx) * d00 + tx * d10)
               + ty * ((1 - tx) * d01 + tx * d11))
    d = jnp.where(corners_ok, d_bilin, d_nearest)

    on_edge = jnp.zeros(d.shape, dtype=bool)
    if edge_threshold > 0:
        d_raw = raw[v, u]
        for du, dv in ((2, 0), (-2, 0), (0, 2), (0, -2)):
            d_nb = raw[jnp.clip(v + dv, 0, h - 1), jnp.clip(u + du, 0, w - 1)]
            on_edge |= (jnp.abs(d_nb - d_raw) > edge_threshold) | (d_nb <= 0.0)
    uvd1 = jnp.stack(
        [xy[:, 0], xy[:, 1], d, jnp.ones_like(d)], axis=-1
    ).astype(jnp.float32)
    xyzw = jnp.einsum("ij,nj->ni", q.astype(jnp.float32), uvd1,
                      precision=jax.lax.Precision.HIGHEST)
    w_coord = xyzw[:, 3]
    safe_w = jnp.where(jnp.abs(w_coord) > 1e-12, w_coord, 1e-12)
    pts = xyzw[:, :3] / safe_w[:, None]
    z = pts[:, 2]
    ok = (d > 0.0) & (z > min_depth) & (z < max_depth) & jnp.isfinite(z) & ~on_edge
    return jnp.where(ok[:, None], pts, 0.0), ok


@partial(jax.jit, static_argnames=("feat_cfg", "odo_cfg"))
def extract_frame_features(
    left: jnp.ndarray,
    disparity: jnp.ndarray,
    q: jnp.ndarray,
    feat_cfg: FeatureConfig,
    odo_cfg: OdometryConfig,
) -> FrameFeatures:
    """Detect + describe + lift: everything odometry keeps per keyframe."""
    kp = detect_and_describe(left, feat_cfg)
    pts, ok = lift_keypoints_to_3d(
        kp.xy, disparity, q,
        max_depth=odo_cfg.max_point_depth,
        edge_threshold=odo_cfg.depth_edge_threshold,
        smooth_radius=odo_cfg.disparity_smooth_radius,
    )
    return FrameFeatures(keypoints=kp, points3d=pts, valid3d=ok & kp.valid)


@partial(jax.jit, static_argnames=("match_cfg", "odo_cfg"))
def odometry_step(
    curr: FrameFeatures,
    prev: FrameFeatures,
    prior_rel: jnp.ndarray,
    key: jax.Array,
    match_cfg: MatchConfig,
    odo_cfg: OdometryConfig,
):
    """One pose-correction step against the previous keyframe.

    prior_rel: (4, 4) flight-log relative pose (prev-camera <- curr-camera),
    the fallback when visual correction fails its fitness gate.

    Returns (rel (4,4) prev<-curr, used_vo (), inlier_count (), matches).
    """
    return _odometry_core(curr, prev, prior_rel, key, match_cfg, odo_cfg)


def _odometry_core(curr, prev, prior_rel, key, match_cfg, odo_cfg):
    matches = match_descriptors(
        curr.keypoints.descriptors,
        prev.keypoints.descriptors,
        curr.keypoints.valid,
        prev.keypoints.valid,
        max_hamming=match_cfg.max_hamming,
        ratio=match_cfg.ratio,
        cross_check=match_cfg.cross_check,
    )
    src = curr.points3d                      # current-camera frame
    dst = prev.points3d[matches.index]       # matched previous-camera points
    pair_ok = matches.valid & curr.valid3d & prev.valid3d[matches.index]

    # pyramid keypoints localize on a 2^octave grid: weight the fit by the
    # inverse localization variance of the coarser side of each pair
    pair_octave = jnp.maximum(curr.keypoints.octave,
                              prev.keypoints.octave[matches.index])
    pair_weight = 0.25 ** pair_octave.astype(jnp.float32)

    enough = jnp.sum(pair_ok) >= odo_cfg.min_matches
    t_vo, inlier_mask, count, fit_ok = ransac_rigid(
        src, dst, pair_ok, key,
        iters=odo_cfg.ransac_iters,
        threshold=odo_cfg.ransac_threshold,
        min_inliers=odo_cfg.min_inliers,
        weights=pair_weight,
        # flight-log relative attitude regularizes the planar-scene tilt
        # modes (refine_rigid_gn); the reference likewise composes its
        # visual correction with the flight-log prior (SURVEY.md §3.3)
        rot_prior=prior_rel[:3, :3],
        rot_prior_weight=odo_cfg.rot_prior_weight,
        depth_rel_weight=odo_cfg.depth_rel_weight,
    )
    used_vo = fit_ok & enough
    rel = jnp.where(used_vo, t_vo, prior_rel)
    # Downstream (window BA) links landmark tracks through these matches.
    # Ratio + cross-check still pass wrong matches whose lateral error is
    # metres at survey altitude; one bad link merges two physical points into
    # one landmark and poisons every pose observing it (measured: track
    # residual RMS 1.4 m lateral vs ~4 cm for the RANSAC-consistent subset).
    # Gate the exported match validity on geometric consistency — and when
    # the rigid fit FAILS, export no links at all. r4 kept the raw matches on
    # fallback ("no geometry to gate with"), which poisoned the whitened
    # window BA: at a survey-row turn the matcher returns hundreds of
    # appearance matches with metre-scale geometric error (RANSAC finds ~0
    # inliers), and with 1/sigma_px^2 lateral weights each surviving wrong
    # link out-votes a GPS prior — measured on the 12-frame turn scene:
    # full-stack ATE 3.4 m (14x prior) with raw fallback links vs 0.2 m
    # with the links dropped. A VO-failed frame restarts its track chains;
    # its pose is still anchored by the flight-log prior terms.
    ba_valid = matches.valid & inlier_mask & used_vo
    matches = matches._replace(valid=ba_valid)
    return rel, used_vo, count, matches


def compose_world_pose(pose_prev: jnp.ndarray, rel: jnp.ndarray) -> jnp.ndarray:
    """World pose of the current frame from the previous world pose and the
    (prev-camera <- curr-camera) relative transform."""
    return se3.compose(pose_prev, rel)


@partial(jax.jit, static_argnames=("match_cfg", "odo_cfg"))
def tracking_step(
    curr: FrameFeatures,
    prev: FrameFeatures,
    kf_pose: jnp.ndarray,
    kf_prior: jnp.ndarray,
    prior: jnp.ndarray,
    key: jax.Array,
    frame_idx: jnp.ndarray,
    match_cfg: MatchConfig,
    odo_cfg: OdometryConfig,
):
    """The whole per-frame tracking update as ONE dispatch.

    Fuses the prior-relative computation inv(kf_prior) @ prior, the RNG
    fold-in, the VO step, and the world-pose composition kf_pose @ rel —
    the online loop's host side stays dispatch-free between stages.

    Returns (pose (4,4), used_vo (), inliers (), matches).
    """
    prior_rel = se3.compose(se3.inverse(kf_prior), prior)
    sub = jax.random.fold_in(key, frame_idx)
    rel, used_vo, count, matches = _odometry_core(
        curr, prev, prior_rel, sub, match_cfg, odo_cfg
    )
    pose = se3.compose(kf_pose, rel)
    return pose, used_vo, count, matches
