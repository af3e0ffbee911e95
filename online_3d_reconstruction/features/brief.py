"""Oriented BRIEF (rBRIEF-style) binary descriptors, fully vectorized.

The reference's ORB descriptors come from OpenCV's learned rBRIEF pattern
(SURVEY.md §2.1 C7). We do not copy that table: the pattern here is the
original BRIEF construction — point pairs drawn from an isotropic Gaussian
over the patch (Calonder et al.) — generated once from a seeded host RNG and
steered by the intensity-centroid orientation exactly as ORB does.

Shape discipline: K keypoint patches are extracted with one
batched gather, orientation is a masked moment sum, and all 256 bit
comparisons for all K keypoints are a single (K, 256, ...) bilinear-gather +
compare, packed to (K, 8) uint32 words for the matmul matcher.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.config import FeatureConfig



class Keypoints(NamedTuple):
    """Static-capacity keypoint set with packed binary descriptors."""

    xy: jnp.ndarray           # (K, 2) float32 pixel coords [x, y] (full-res)
    score: jnp.ndarray        # (K,) float32 detection score
    angle: jnp.ndarray        # (K,) float32 orientation (radians)
    descriptors: jnp.ndarray  # (K, W) uint32 packed binary descriptor words
    valid: jnp.ndarray        # (K,) bool
    octave: jnp.ndarray       # (K,) int32 pyramid level (0 = full resolution)


def brief_pattern(bits: int, patch_size: int, seed: int) -> np.ndarray:
    """(bits, 4) float32 point-pair offsets (y1, x1, y2, x2), host-side.

    Gaussian BRIEF sampling: offsets ~ N(0, (patch/5)^2), clipped inside the
    patch with a 1px bilinear-sampling margin.
    """
    rng = np.random.default_rng(seed)
    sigma = patch_size / 5.0
    lim = patch_size // 2 - 2
    pts = rng.normal(0.0, sigma, size=(bits, 4))
    return np.clip(pts, -lim, lim).astype(np.float32)


def _gaussian_blur(image: jnp.ndarray) -> jnp.ndarray:
    """Separable 5-tap binomial blur (BRIEF needs a smoothed image)."""
    k = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=jnp.float32) / 16.0
    pad = jnp.pad(image, ((2, 2), (0, 0)), mode="edge")
    rows = sum(k[i] * pad[i : i + image.shape[0], :] for i in range(5))
    pad = jnp.pad(rows, ((0, 0), (2, 2)), mode="edge")
    return sum(k[i] * pad[:, i : i + image.shape[1]] for i in range(5))


def _extract_patches(image: jnp.ndarray, xy: jnp.ndarray, patch: int) -> jnp.ndarray:
    """(K, P, P) patches centered on integer keypoint coords.

    Row gather (contiguous, cheap) + one-hot column-selection batched
    matmul in place of a 2D advanced-indexing gather (K*P*P scattered
    element reads) (chosen for the earlier accelerator target; not yet measured on the H100).
    """
    half = patch // 2
    h, w = image.shape
    cx = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), half, w - 1 - half)
    cy = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), half, h - 1 - half)
    dy = jnp.arange(-half, half + 1, dtype=jnp.int32)
    dx = jnp.arange(-half, half + 1, dtype=jnp.int32)
    row_patch = image[cy[:, None] + dy[None, :], :]          # (K, P, W)
    colsel = (jnp.arange(w, dtype=jnp.int32)[None, :, None]
              == (cx[:, None, None] + dx[None, None, :]))    # (K, W, P)
    # HIGHEST: a one-hot selection must be exact — the default bf16 matmul
    # precision would quantize the patch pixels
    return jnp.einsum("kpw,kwc->kpc", row_patch, colsel.astype(image.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def _orientation(patches: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle atan2(m01, m10) over a circular mask."""
    k, p, _ = patches.shape
    half = p // 2
    coords = jnp.arange(p, dtype=jnp.float32) - half
    yy = coords[:, None]
    xx = coords[None, :]
    circ = (yy * yy + xx * xx) <= half * half
    masked = jnp.where(circ[None], patches, 0.0)
    m10 = jnp.sum(masked * xx[None], axis=(1, 2))
    m01 = jnp.sum(masked * yy[None], axis=(1, 2))
    return jnp.arctan2(m01, m10)


def _sample_bilinear_matmul(patches: jnp.ndarray, py: jnp.ndarray,
                            px: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sampling of (K, P, P) patches at (K, B) float coords as two
    batched matmul contractions — no gathers.

    The hat function relu(1 - |y - py|) over the integer grid IS the pair of
    bilinear weights (1-ty at floor(py), ty at floor(py)+1), so separable
    bilinear interpolation is an exact rank-1 stencil contraction. The
    gather formulation this replaces (4 corner gathers x K x B points) was
    the slower one on the earlier accelerator target (not yet measured on
    the H100); out-of-patch coords clamp to the edge.
    """
    p = patches.shape[1]
    coords = jnp.arange(p, dtype=jnp.float32)
    py = jnp.clip(py, 0.0, p - 1.0)
    px = jnp.clip(px, 0.0, p - 1.0)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(coords[None, None, :] - py[:, :, None]))
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(coords[None, None, :] - px[:, :, None]))
    rows = jnp.einsum("kyx,kby->kbx", patches, wy,
                      precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(rows * wx, axis=-1)


def _pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(K, B) bool -> (K, B/32) uint32, LSB-first within each word."""
    k, b = bits.shape
    assert b % 32 == 0
    words = bits.reshape(k, b // 32, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1).astype(jnp.uint32)


@partial(jax.jit, static_argnames=("config",))
def describe_keypoints(image: jnp.ndarray, xy: jnp.ndarray, score: jnp.ndarray,
                       valid: jnp.ndarray, config: FeatureConfig) -> Keypoints:
    """Compute orientations + steered BRIEF descriptors for detected corners.

    Single-level: xy are coordinates in ``image``; octave is set to 0.
    Fractional xy (subpixel-refined detections) are honored exactly: patches
    are extracted on the integer grid and the fractional residual shifts the
    pattern-sampling coordinates, so every descriptor bit compares
    intensities at the keypoint's true subpixel position.

    All sampling is matmuls — patch extraction is a row gather + one-hot
    column matmul, and the continuous-angle steered pattern comparison is
    exact separable bilinear interpolation as hat-weight contractions
    (_sample_bilinear_matmul); no data-dependent gathers anywhere."""
    pattern = jnp.asarray(
        brief_pattern(config.descriptor_bits, config.patch_size, config.seed)
    )
    blurred = _gaussian_blur(image.astype(jnp.float32))
    patches = _extract_patches(blurred, xy, config.patch_size)
    angle = _orientation(patches)

    half = config.patch_size // 2
    # the same clip+round _extract_patches used: residual = true - patch center
    h_img, w_img = image.shape
    pcx = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), half, w_img - 1 - half)
    pcy = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), half, h_img - 1 - half)
    res_x = (xy[:, 0] - pcx.astype(jnp.float32))[:, None]
    res_y = (xy[:, 1] - pcy.astype(jnp.float32))[:, None]
    cos_t = jnp.cos(angle)[:, None]
    sin_t = jnp.sin(angle)[:, None]
    y1, x1, y2, x2 = pattern[:, 0], pattern[:, 1], pattern[:, 2], pattern[:, 3]

    def rotate(y, x):
        # steer the sampling pattern by the keypoint orientation, centered on
        # the keypoint's subpixel position within the integer patch
        ry = x[None, :] * sin_t + y[None, :] * cos_t
        rx = x[None, :] * cos_t - y[None, :] * sin_t
        return ry + half + res_y, rx + half + res_x

    ry1, rx1 = rotate(y1, x1)
    ry2, rx2 = rotate(y2, x2)
    i1 = _sample_bilinear_matmul(patches, ry1, rx1)
    i2 = _sample_bilinear_matmul(patches, ry2, rx2)
    bits = i1 < i2
    desc = _pack_bits(bits)
    desc = jnp.where(valid[:, None], desc, 0)
    return Keypoints(xy=xy, score=score, angle=angle, descriptors=desc,
                     valid=valid, octave=jnp.zeros(xy.shape[0], jnp.int32))


def _downsample2(image: jnp.ndarray) -> jnp.ndarray:
    """2x2 average pooling (even dims; odd trailing row/col dropped)."""
    h, w = image.shape
    h2, w2 = h // 2, w // 2
    x = image[: 2 * h2, : 2 * w2].reshape(h2, 2, w2, 2)
    return x.mean(axis=(1, 3))


def _level_budgets(total: int, levels: int) -> list:
    """Per-level keypoint caps, halving per level (ORB-style), summing to total."""
    raw = [0.5 ** l for l in range(levels)]
    norm = sum(raw)
    caps = [max(1, int(round(total * r / norm))) for r in raw]
    caps[0] += total - sum(caps)
    return caps


@partial(jax.jit, static_argnames=("config",))
def detect_and_describe(image: jnp.ndarray, config: FeatureConfig) -> Keypoints:
    """Full C7 stage: pyramid FAST detection + oriented BRIEF description.

    The reference's ORB detects on an image pyramid (SURVEY.md C7); here each
    2x-downsampled level gets a halving share of the keypoint budget, is
    detected + described at its own scale, and coordinates are mapped back to
    full resolution. Total capacity stays exactly ``max_keypoints``.
    """
    from online_3d_reconstruction.features.fast import detect_keypoints

    # drop levels too small for the descriptor patch (static shapes)
    levels = 1
    h, w = image.shape
    min_side = 2 * (config.patch_size + 2 * config.nms_radius + 8)
    while (
        levels < config.num_levels
        and min(h, w) // (2 ** levels) >= min_side
    ):
        levels += 1
    caps = _level_budgets(config.max_keypoints, levels)

    parts = []
    img_l = image
    for level in range(levels):
        if level:
            img_l = _downsample2(img_l)
        xy, score, valid = detect_keypoints(
            img_l,
            max_keypoints=caps[level],
            threshold=config.fast_threshold / 255.0,
            arc=config.fast_arc,
            nms_radius=config.nms_radius,
            border=config.border,
            grid_tiles=config.grid_tiles,
            # kills the +-0.5 px detection quantization — the measured
            # dominant (frame-correlated) BA observation-error term
            subpixel=config.subpixel,
        )
        kp = describe_keypoints(img_l, xy, score, valid, config)
        scale = float(2 ** level)
        parts.append(
            kp._replace(
                xy=kp.xy * scale,
                octave=jnp.full(caps[level], level, jnp.int32),
            )
        )
    return Keypoints(
        xy=jnp.concatenate([p.xy for p in parts]),
        score=jnp.concatenate([p.score for p in parts]),
        angle=jnp.concatenate([p.angle for p in parts]),
        descriptors=jnp.concatenate([p.descriptors for p in parts]),
        valid=jnp.concatenate([p.valid for p in parts]),
        octave=jnp.concatenate([p.octave for p in parts]),
    )
