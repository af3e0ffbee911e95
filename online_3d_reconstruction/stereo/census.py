"""Census transform + Hamming cost volume.

The reference's disparity cost lives inside ``cv::StereoSGBM`` (a
Birchfield-Tomasi sampling-insensitive cost, SURVEY.md §3.2). We choose
the census transform instead: it is a pure stencil + bit-packing op
(elementwise, no data-dependent branching), its Hamming-distance matching
cost maps onto ``lax.population_count``, and it is robust to the
radiometric differences a real stereo rig has.

The (H, W, D) cost volume is built by one gather of the right census image
over a (W, D) index grid — no per-d Python loop, one fused XLA op.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("window",))
def census_transform(image: jnp.ndarray, window: Tuple[int, int] = (5, 5)) -> jnp.ndarray:
    """Census-transform a grayscale image into packed uint32 codes.

    Each pixel's code has one bit per non-center neighbor in the window
    (row-major order): bit = 1 iff neighbor < center. Window sizes up to
    32 bits (e.g. 5x5 -> 24 bits, 5x7 -> 34 would overflow -> rejected).
    Borders use edge-replicated padding.
    """
    wh, ww = window
    if (wh * ww - 1) > 32:
        raise ValueError(f"census window {window} needs >32 bits")
    if wh % 2 == 0 or ww % 2 == 0:
        raise ValueError("census window must be odd-sized")
    ry, rx = wh // 2, ww // 2

    img = image.astype(jnp.float32)
    padded = jnp.pad(img, ((ry, ry), (rx, rx)), mode="edge")
    h, w = image.shape

    code = jnp.zeros(image.shape, dtype=jnp.uint32)
    bit = 0
    for dy in range(-ry, ry + 1):
        for dx in range(-rx, rx + 1):
            if dy == 0 and dx == 0:
                continue
            neighbor = jax.lax.dynamic_slice(padded, (dy + ry, dx + rx), (h, w))
            code = code | (jnp.where(neighbor < img, jnp.uint32(1), jnp.uint32(0)) << bit)
            bit += 1
    return code


@partial(jax.jit, static_argnames=("max_disparity",))
def cost_volume(census_left: jnp.ndarray, census_right: jnp.ndarray,
                max_disparity: int) -> jnp.ndarray:
    """Hamming-distance cost volume: cost[y, x, d] = popcount(L[y,x] ^ R[y,x-d]).

    Out-of-image (x - d < 0) hypotheses get the maximum cost so aggregation
    never prefers them. Output int32 (H, W, D); values in [0, census_bits].
    """
    h, w = census_left.shape
    d = max_disparity

    # One gather builds all D shifted copies of the right image: pad the left
    # edge with D columns of sentinel, index with a (W, D) grid.
    pad_val = jnp.uint32(0xFFFFFFFF)
    padded_r = jnp.concatenate(
        [jnp.full((h, d), pad_val, dtype=census_right.dtype), census_right], axis=1
    )  # (H, W + D)
    cols = jnp.arange(w, dtype=jnp.int32)[:, None] - jnp.arange(d, dtype=jnp.int32)[None, :] + d
    shifted_r = padded_r[:, cols]  # (H, W, D)

    xor = census_left[:, :, None] ^ shifted_r
    cost = jax.lax.population_count(xor).astype(jnp.int32)
    # Sentinel-region popcounts are meaningless; clamp to the max real cost.
    max_bits = jnp.int32(32)
    oob = (jnp.arange(w, dtype=jnp.int32)[:, None] - jnp.arange(d, dtype=jnp.int32)[None, :]) < 0
    return jnp.where(oob[None, :, :], max_bits, cost)
