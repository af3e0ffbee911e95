"""Disparity -> colored point cloud backprojection.

The reference walks each pixel with valid disparity (stride-subsampled) and
computes ``(X, Y, Z) = Q @ (u, v, d, 1)`` per ``cv::reprojectImageTo3D``
semantics, building a ``pcl::PointXYZRGB`` cloud (SURVEY.md §2.1 C6, §3.1).

Design: fully vectorized XLA. The whole image is backprojected as
one fused elementwise expression; invalid / out-of-band pixels are masked
rather than compacted, keeping shapes static. Stride subsampling is a static
reshape-slice. Output is a fixed-capacity ``(N, 3)`` point array + ``(N, 3)``
colors + ``(N,)`` validity mask — the framework's universal cloud format.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp


class PointCloud(NamedTuple):
    """Fixed-capacity masked point cloud (the pcl::PointCloud analog)."""

    points: jnp.ndarray  # (N, 3) float32
    colors: jnp.ndarray  # (N, 3) float32 in [0, 1]
    valid: jnp.ndarray   # (N,) bool


def q_matrix(fx: float, fy: float, cx: float, cy: float, baseline: float,
             cx_right: Optional[float] = None) -> jnp.ndarray:
    """Build the 4x4 disparity-to-depth reprojection matrix Q.

    Matches ``cv::stereoRectify``'s Q convention for a rectified pair:
      [X Y Z W]^T = Q @ [u v d 1]^T,  point = (X, Y, Z) / W
    with Q = [[1, 0, 0, -cx], [0, 1, 0, -cy], [0, 0, 0, f],
              [0, 0, 1/B, (cx - cx')/B]].
    (fy is accepted for API parity; rectified pairs share f = fx = fy.)
    """
    del fy
    if cx_right is None:
        cx_right = cx
    return jnp.array(
        [
            [1.0, 0.0, 0.0, -cx],
            [0.0, 1.0, 0.0, -cy],
            [0.0, 0.0, 0.0, fx],
            [0.0, 0.0, 1.0 / baseline, (cx - cx_right) / baseline],
        ],
        dtype=jnp.float32,
    )


def backproject_disparity(
    disparity: jnp.ndarray,
    color: jnp.ndarray,
    q: jnp.ndarray,
    stride: int = 1,
    min_depth: float = 0.1,
    max_depth: float = jnp.inf,
    invalid_value: float = -1.0,
    color_prestrided: bool = False,
    color_substride: int = 1,
) -> PointCloud:
    """Backproject a (H, W) disparity map to a masked point cloud.

    color: (H, W) grayscale or (H, W, 3) RGB in [0, 1] or [0, 255].
    stride: static pixel subsample ("jump pixels" in the reference CLI).
    color_prestrided: the color plane is already on the strided output grid
    (ceil(H/stride), ceil(W/stride)) — the online loop ships color at the
    cloud stride to cut host->device wire bytes (pipeline.pack_frame).
    color_substride s > 1: the prestrided color plane is s x coarser than
    the point grid (stride * s pixels); each color serves an s x s block of
    points via a static repeat — a pure wire-bytes/visual-fidelity trade
    (MappingConfig.color_stride).
    """
    h, w = disparity.shape
    disp = disparity[::stride, ::stride]
    hh, ww = disp.shape

    u = jnp.arange(0, w, stride, dtype=jnp.float32)[None, :]
    v = jnp.arange(0, h, stride, dtype=jnp.float32)[:, None]
    u = jnp.broadcast_to(u, (hh, ww))
    v = jnp.broadcast_to(v, (hh, ww))
    ones = jnp.ones_like(disp, dtype=jnp.float32)
    uvd1 = jnp.stack([u, v, disp.astype(jnp.float32), ones], axis=-1)  # (hh, ww, 4)

    # HIGHEST precision: a reduced-precision default (TF32 on the GPU)
    # would quantize depth.
    xyzw = jnp.einsum(
        "ij,hwj->hwi", q.astype(jnp.float32), uvd1,
        precision=jax.lax.Precision.HIGHEST,
    )
    w_coord = xyzw[..., 3]
    safe_w = jnp.where(jnp.abs(w_coord) > 1e-12, w_coord, 1e-12)
    xyz = xyzw[..., :3] / safe_w[..., None]
    z = xyz[..., 2]

    valid = (disp > invalid_value + 0.5) & (disp > 0.0)
    valid &= (z > min_depth) & (z < max_depth) & jnp.isfinite(z)

    if color.ndim == 2:
        color = color[..., None].repeat(3, axis=-1)
    if color_prestrided:
        if color_substride > 1:
            color = jnp.repeat(jnp.repeat(color, color_substride, axis=0),
                               color_substride, axis=1)
        col = color[:hh, :ww, :3].astype(jnp.float32)
    else:
        col = color[::stride, ::stride, :3].astype(jnp.float32)
    if color.dtype == jnp.uint8:  # static dtype check: normalize uint8 to [0, 1]
        col = col / 255.0

    n = hh * ww
    return PointCloud(
        points=jnp.where(valid[..., None], xyz, 0.0).reshape(n, 3),
        colors=col.reshape(n, 3),
        valid=valid.reshape(n),
    )


def cloud_stats(cloud: PointCloud) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(valid count, centroid of valid points) — cheap online diagnostics."""
    count = jnp.sum(cloud.valid)
    safe = jnp.maximum(count, 1)
    centroid = jnp.sum(jnp.where(cloud.valid[:, None], cloud.points, 0.0), axis=0) / safe
    return count, centroid
