"""Stereo rectification remap: XLA gather + banded hat-weight matmul forms.

The reference calls ``cv::remap`` with maps from ``initUndistortRectifyMap``
every frame (SURVEY.md §2.1 C4). Two formulations:

- ``remap_bilinear``: four data-dependent gathers + fused lerp. Simple and
  exact; on the earlier accelerator target random-access gathers ran
  serially, so the online loop uses the banded form (not yet compared on
  the H100).
- ``remap_bilinear_banded``: the hot-path form. A rectification map is a
  *smooth, static* warp, so each output row only reads a narrow static band
  of source rows. Per row-block: one cheap row gather of the band, then the
  exact bilinear weights are generated ON THE FLY as hat functions
  relu(1 - |coord - i|) and contracted in a matmul (the same trick as
  features/brief._sample_bilinear_matmul). A lax.scan
  over row blocks keeps the generated weight tensor at a few MB instead of
  H*W*W. Identical math to the gather form (f32 hat weights, HIGHEST
  precision).

Maps are built once on the host (io/calibration.py) and live on-device for
the whole run; ``vertical_band`` (host-side) sizes the static band.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("fill",))
def remap_bilinear(image: jnp.ndarray, map_xy: jnp.ndarray, fill: float = 0.0) -> jnp.ndarray:
    """Sample ``image`` (H, W) or (H, W, C) at ``map_xy`` (H', W', 2) coords.

    map_xy[..., 0] is the source x (column), [..., 1] the source y (row) —
    the cv::remap convention. Out-of-bounds pixels get ``fill``.
    """
    h, w = image.shape[:2]
    x = map_xy[..., 0].astype(jnp.float32)
    y = map_xy[..., 1].astype(jnp.float32)

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    valid = (x0i >= 0) & (x0i <= w - 2) & (y0i >= 0) & (y0i <= h - 2)
    x0c = jnp.clip(x0i, 0, w - 2)
    y0c = jnp.clip(y0i, 0, h - 2)

    v00 = image[y0c, x0c]
    v10 = image[y0c, x0c + 1]
    v01 = image[y0c + 1, x0c]
    v11 = image[y0c + 1, x0c + 1]

    if image.ndim == 3:
        tx = tx[..., None]
        ty = ty[..., None]
        valid = valid[..., None]

    img_dtype = image.dtype
    v00 = v00.astype(jnp.float32)
    v10 = v10.astype(jnp.float32)
    v01 = v01.astype(jnp.float32)
    v11 = v11.astype(jnp.float32)
    out = (
        v00 * (1 - tx) * (1 - ty)
        + v10 * tx * (1 - ty)
        + v01 * (1 - tx) * ty
        + v11 * tx * ty
    )
    out = jnp.where(valid, out, fill)
    if jnp.issubdtype(img_dtype, jnp.integer):
        out = jnp.round(out)
    return out.astype(img_dtype)


def vertical_band(map_xy: np.ndarray) -> int:
    """Static source-row band height needed by any one output row (host).

    For each output row the bilinear remap reads source rows
    [min_j floor(y), max_j floor(y) + 1]; the band is the worst case over
    rows, rounded up to a multiple of 4. Smooth
    rectification maps give single-digit bands; a degenerate map (e.g. a
    transpose-like warp) gives a band ~H and the caller should fall back to
    the gather form.
    """
    y = np.asarray(map_xy[..., 1], dtype=np.float64)
    y0 = np.floor(y)
    spread = (y0.max(axis=1) - y0.min(axis=1)).max() if y.size else 0.0
    band = int(spread) + 2
    return max(4, -(-band // 4) * 4)


@partial(jax.jit, static_argnames=("band", "fill", "block"))
def remap_bilinear_banded(image: jnp.ndarray, map_xy: jnp.ndarray,
                          band: int, fill: float = 0.0,
                          block: int = 8) -> jnp.ndarray:
    """Exact bilinear remap as band row-gather + on-the-fly hat matmuls.

    Equivalent to ``remap_bilinear`` (same out-of-bounds/fill semantics) for
    any map whose per-output-row source-row spread fits in ``band``
    (``vertical_band`` computes it). image (H_in, W_in) or (H_in, W_in, C);
    map_xy (H_out, W_out, 2) in cv::remap convention.
    """
    h_in, w_in = image.shape[:2]
    h_out, w_out = map_xy.shape[:2]
    band = min(band, h_in)  # band == h_in degenerates to all rows, still exact
    chan = image.ndim == 3
    x = map_xy[..., 0].astype(jnp.float32)
    y = map_xy[..., 1].astype(jnp.float32)

    x0i = jnp.floor(x).astype(jnp.int32)
    y0i = jnp.floor(y).astype(jnp.int32)
    valid = (x0i >= 0) & (x0i <= w_in - 2) & (y0i >= 0) & (y0i <= h_in - 2)

    # static band of source rows per output row; lo's clip keeps every band
    # row in-image (no duplicates, so hat weights never double-count)
    lo = jnp.clip(jnp.min(y0i, axis=1), 0, h_in - band)  # (H_out,)
    row_idx = lo[:, None] + jnp.arange(band, dtype=jnp.int32)[None, :]
    band_rows = image[row_idx]          # (H_out, band, W_in[, C]) row gather

    # pad the row axis so fixed-size blocks tile it exactly
    pad_rows = (-h_out) % block
    def pad0(a):
        return jnp.pad(a, ((0, pad_rows),) + ((0, 0),) * (a.ndim - 1))
    xb = pad0(x).reshape(-1, block, w_out)
    yb = pad0(y).reshape(-1, block, w_out)
    rib = pad0(row_idx).reshape(-1, block, band)
    bandb = pad0(band_rows).reshape((-1, block, band, w_in) + image.shape[2:])
    cols = jnp.arange(w_in, dtype=jnp.float32)

    def one_block(args):
        xr, yr, rir, br = args
        # horizontal: S[r, j, b] = sum_c relu(1-|x-c|) * band[r, b, c]
        wh = jnp.maximum(0.0, 1.0 - jnp.abs(xr[:, :, None] - cols[None, None, :]))
        eq = "rjc,rbc->rjb" if not chan else "rjc,rbcC->rjbC"
        s = jnp.einsum(eq, wh, br.astype(jnp.float32),
                       precision=jax.lax.Precision.HIGHEST)
        # vertical: out[r, j] = sum_b relu(1-|y-row_b|) * S[r, j, b]
        wv = jnp.maximum(0.0, 1.0 - jnp.abs(yr[:, :, None]
                                            - rir[:, None, :].astype(jnp.float32)))
        if chan:
            wv = wv[..., None]
            return jnp.sum(wv * s, axis=2)
        return jnp.sum(wv * s, axis=2)

    out = jax.lax.map(one_block, (xb, yb, rib, bandb))
    out = out.reshape((-1, w_out) + image.shape[2:])[:h_out]

    if chan:
        valid = valid[..., None]
    out = jnp.where(valid, out, fill)
    if jnp.issubdtype(image.dtype, jnp.integer):
        out = jnp.round(out)
    return out.astype(image.dtype)


@partial(jax.jit, static_argnames=("band_left", "band_right"))
def rectify_pair(left: jnp.ndarray, right: jnp.ndarray,
                 map_left: jnp.ndarray, map_right: jnp.ndarray,
                 band_left: int = 0, band_right: int = 0):
    """Rectify both views of a stereo pair in one fused dispatch.

    ``band_left``/``band_right`` > 0 select the banded matmul form (the online
    loop passes ``vertical_band`` of each map); 0 keeps the gather form.
    """
    if band_left > 0:
        l = remap_bilinear_banded(left, map_left, band_left)
    else:
        l = remap_bilinear(left, map_left)
    if band_right > 0:
        r = remap_bilinear_banded(right, map_right, band_right)
    else:
        r = remap_bilinear(right, map_right)
    return l, r
