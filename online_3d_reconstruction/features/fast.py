"""FAST corner detection as fused stencil ops.

The reference detects keypoints with OpenCV's (CUDA) ORB, whose detector is
FAST-9 on an image pyramid with a Harris/FAST score and grid-based retention
(SURVEY.md §2.1 C7). A data-dependent corner list is hostile to XLA, so the
design keeps everything dense and static-shape:

- the 16-pixel Bresenham circle test is 16 static shifted images + a
  windowed-sum contiguity check (elementwise, no branching);
- the score map gets 2D non-max suppression via ``lax.reduce_window``;
- retention is *top-k per spatial tile* (static k), the static-shape analog
  of ORB's bucketed retention, followed by a global top-k to the fixed
  keypoint capacity. Invalid slots are masked, never compacted.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3: 16 (dy, dx) offsets in clockwise order.
CIRCLE16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shifted_stack(image: jnp.ndarray, offsets) -> jnp.ndarray:
    """(16, H, W) stack of circle-neighbor values (edge-replicated borders)."""
    pad = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    padded = jnp.pad(image, pad, mode="edge")
    h, w = image.shape
    return jnp.stack(
        [
            jax.lax.dynamic_slice(padded, (dy + pad, dx + pad), (h, w))
            for dy, dx in offsets
        ]
    )


def _score_maps(image: jnp.ndarray, threshold: float, arc: int):
    """(gated, excess) FAST score maps.

    ``gated`` is the classical FAST-N score (0 where the contiguous-arc
    corner test fails) used for NMS/ranking. ``excess`` is the UNGATED
    summed threshold-excess — continuous in the image intensities, which the
    gated map is not (the arc test flips discretely), so it is the surface
    the subpixel parabola fit reads.
    """
    neighbors = _shifted_stack(image, CIRCLE16)  # (16, H, W)
    center = image[None]
    bright = (neighbors > center + threshold).astype(jnp.float32)
    dark = (neighbors < center - threshold).astype(jnp.float32)

    def has_arc(mask16: jnp.ndarray) -> jnp.ndarray:
        # circular windowed sum of length `arc` over the 16 positions
        wrapped = jnp.concatenate([mask16, mask16[: arc - 1]], axis=0)  # (16+arc-1, H, W)
        csum = jnp.cumsum(wrapped, axis=0)
        csum = jnp.concatenate([jnp.zeros_like(csum[:1]), csum], axis=0)
        window = csum[arc:] - csum[:-arc]  # (16, H, W)
        return jnp.max(window, axis=0) >= arc

    is_corner = has_arc(bright) | has_arc(dark)
    excess_b = jnp.sum(jnp.maximum(neighbors - center - threshold, 0.0), axis=0)
    excess_d = jnp.sum(jnp.maximum(center - threshold - neighbors, 0.0), axis=0)
    excess = jnp.maximum(excess_b, excess_d)
    return jnp.where(is_corner, excess, 0.0), excess


@partial(jax.jit, static_argnames=("threshold", "arc"))
def fast_score(image: jnp.ndarray, threshold: float = 20.0 / 255.0,
               arc: int = 9) -> jnp.ndarray:
    """FAST-N corner score map (0 where not a corner).

    image: (H, W) grayscale float in [0, 1]; threshold on the same scale.
    A pixel is a corner iff >= ``arc`` contiguous circle pixels are all
    brighter than center+t or all darker than center-t. Score is the summed
    threshold-excess over the circle (the ranking OpenCV uses for NMS).
    """
    return _score_maps(image, threshold, arc)[0]


def _nms(score: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Keep only strict local maxima within a (2r+1)^2 window."""
    if radius <= 0:
        return score
    win = 2 * radius + 1
    local_max = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (win, win), (1, 1), "SAME"
    )
    return jnp.where(score >= local_max, score, 0.0)


@partial(jax.jit, static_argnames=("max_keypoints", "threshold", "arc", "nms_radius",
                                   "border", "grid_tiles", "subpixel"))
def detect_keypoints(
    image: jnp.ndarray,
    max_keypoints: int = 512,
    threshold: float = 20.0 / 255.0,
    arc: int = 9,
    nms_radius: int = 3,
    border: int = 20,
    grid_tiles: Tuple[int, int] = (4, 4),
    subpixel: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Detect up to ``max_keypoints`` FAST corners with tiled retention.

    Returns (xy (K, 2) float32 [x, y], score (K,) float32, valid (K,) bool).
    Slots beyond the number of detected corners have score 0 and valid=False.
    With ``subpixel`` the returned xy carry the score-surface parabola
    refinement (``refine_subpixel_score``); integer otherwise.
    """
    h, w = image.shape
    gated, excess = _score_maps(image, threshold, arc)
    score = _nms(gated, nms_radius)

    # Exclude a border so descriptor patches stay in-image.
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = jnp.where(in_border, score, 0.0)

    ty, tx = grid_tiles
    # Pad so tiles divide evenly (padding scores are 0 = never selected).
    ph = (-h) % ty
    pw = (-w) % tx
    padded = jnp.pad(score, ((0, ph), (0, pw)))
    hh, ww = padded.shape
    th, tw = hh // ty, ww // tx

    k_per_tile = -(-max_keypoints // (ty * tx))  # ceil
    k_per_tile = min(k_per_tile * 2, th * tw)    # 2x oversample for uneven texture

    tiles = padded.reshape(ty, th, tx, tw).transpose(0, 2, 1, 3).reshape(ty * tx, th * tw)
    tile_scores, tile_idx = jax.lax.top_k(tiles, k_per_tile)  # (T, k)

    tile_row = jnp.arange(ty * tx, dtype=jnp.int32) // tx
    tile_col = jnp.arange(ty * tx, dtype=jnp.int32) % tx
    y0 = (tile_row * th)[:, None] + tile_idx // tw
    x0 = (tile_col * tw)[:, None] + tile_idx % tw

    flat_scores = tile_scores.reshape(-1)
    flat_y = y0.reshape(-1)
    flat_x = x0.reshape(-1)

    top_scores, top_i = jax.lax.top_k(flat_scores, max_keypoints)
    xy = jnp.stack(
        [flat_x[top_i].astype(jnp.float32), flat_y[top_i].astype(jnp.float32)], axis=-1
    )
    valid = top_scores > 0.0
    if subpixel:
        xy = refine_subpixel_score(excess, xy, valid)
    return xy, top_scores, valid


def refine_subpixel_score(
    excess: jnp.ndarray,
    xy: jnp.ndarray,
    valid: jnp.ndarray,
) -> jnp.ndarray:
    """Subpixel peak localization on the detector's own score surface.

    FAST detections land on integer pixels; that +-0.5 px quantization is
    *frame-correlated* across observations of the same physical corner and
    was measured to be the dominant BA observation-error term (lateral RMS
    ~0.2 px of pure quantization; see BASELINE.md ATE section). The fix must
    be translation-EQUIVARIANT — when the image content shifts by delta, the
    refined coordinate must shift by delta — which the detection score
    surface gives by construction (it is recomputed identically per frame),
    whereas a gradient-centroid/cornerSubPix solve was measured to move
    detections ~1 px toward texture-dependent attractors and made track
    consistency WORSE on dense natural texture. Per-axis 3-point parabola
    fit on the UNGATED excess surface (continuous in the image; the gated
    FAST score jumps when a neighbor's arc test flips), offsets clamped to
    the +-0.5 px cell. Same stencil pattern as the SGM WTA subpixel fit
    (stereo/sgm.py).
    """
    h, w = excess.shape
    px = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 1, w - 2)
    py = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 1, h - 2)
    s_c = excess[py, px]
    s_l = excess[py, px - 1]
    s_r = excess[py, px + 1]
    s_u = excess[py - 1, px]
    s_d = excess[py + 1, px]

    def parabola(lo, c, hi):
        denom = lo - 2.0 * c + hi
        ok = denom < -1e-9          # strictly concave around the peak
        off = jnp.where(ok, 0.5 * (lo - hi) / jnp.where(ok, denom, -1.0), 0.0)
        return jnp.clip(off, -0.5, 0.5)

    ox = parabola(s_l, s_c, s_r)
    oy = parabola(s_u, s_c, s_d)
    cand = jnp.stack([px.astype(jnp.float32) + ox,
                      py.astype(jnp.float32) + oy], axis=-1)
    return jnp.where(valid[:, None], cand, xy)
