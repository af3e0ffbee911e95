"""Semi-global matching (SGM) disparity.

The reference computes disparity with ``cv::StereoSGBM::create(...)->compute()``
(SURVEY.md §2.1 C5, §3.2): per-pixel matching cost over D hypotheses, path-wise
dynamic-programming aggregation with P1/P2 smoothness penalties over 4-8 scan
directions, winner-take-all with uniqueness ratio, subpixel parabola fit,
left-right consistency and speckle filtering.

Design:

- The path recurrence
    L_r(p,d) = C(p,d) + min(L_r(p-r,d), L_r(p-r,d±1)+P1, min_k L_r(p-r,k)+P2)
               - min_k L_r(p-r,k)
  is a sequential scan along the path direction, vectorized over the
  perpendicular image axis and the disparity axis. Two implementations
  compute it, chosen by ``StereoConfig.aggregation`` (``aggregate``):
  ``aggregate_scan`` here, a ``jax.lax.scan`` that runs anywhere and is the
  reference; and ``sgm_cuda.aggregate_cuda``, a CUDA kernel for the GPU.
- Volumes are (H, W, D), D contiguous: the layout the CUDA kernel reads
  coalesced, one pixel's D costs per warp step.
- WTA / uniqueness / subpixel / LR-check are fused elementwise XLA; the
  right-view disparity and LR cross-check are gather-free (pad/reshape
  shears + one-hot reductions).
- The speckle filter (cv2.filterSpeckles semantics) is the scan-only
  "run-cross mass" bound of ``speckle_filter``: 8 segmented cumulative
  sums, no scatters, no while_loop; it differs from cv2's exact connected
  components on 0.004% of pixels.

Everything is static-shape with no data-dependent control flow at all.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from online_3d_reconstruction.config import StereoConfig
from online_3d_reconstruction.stereo.census import census_transform, cost_volume

# Python float, not a jnp constant: module import must not touch a backend.
_BIG = 1e9


# ---------------------------------------------------------------------------
# Path aggregation (lax.scan reference implementation)
# ---------------------------------------------------------------------------

def _sgm_step(carry: jnp.ndarray, cost_slice: jnp.ndarray, p1: float, p2: float):
    """One SGM recurrence step, vectorized over (L, D).

    carry: previous line's aggregated costs L_r(p-r, :) of shape (L, D).
    cost_slice: this line's matching costs C(p, :) of shape (L, D).
    """
    min_prev = jnp.min(carry, axis=-1, keepdims=True)
    edge = jnp.full_like(carry[:, :1], _BIG)
    d_minus = jnp.concatenate([edge, carry[:, :-1]], axis=1) + p1
    d_plus = jnp.concatenate([carry[:, 1:], edge], axis=1) + p1
    best = jnp.minimum(
        jnp.minimum(carry, min_prev + p2), jnp.minimum(d_minus, d_plus)
    )
    new = cost_slice + best - min_prev
    return new, new


def _scan_path(cost: jnp.ndarray, p1: float, p2: float, reverse: bool,
               shift: int = 0) -> jnp.ndarray:
    """Aggregate along axis 0 of an (S, L, D) volume in one direction.

    ``shift`` (+1/-1) turns the vertical recurrence into a diagonal one: the
    predecessor of (s, l) on the (1, +-1) diagonal is (s-1, l-+1), so the
    carry is shifted one line with zero fill before each step — a zero carry
    is exactly the fresh-start initial condition at the image border (this
    replaced the earlier skew-the-volume formulation, whose pad cells leaked
    a d-dependent residual into border restarts; see TestDiagonalExact).
    Reverse traversal of a diagonal flips the lane shift too.
    """
    eff = -shift if reverse else shift

    def step(carry, cost_slice):
        if eff > 0:
            carry = jnp.concatenate([jnp.zeros_like(carry[:1]), carry[:-1]], axis=0)
        elif eff < 0:
            carry = jnp.concatenate([carry[1:], jnp.zeros_like(carry[:1])], axis=0)
        return _sgm_step(carry, cost_slice, p1, p2)

    init = jnp.zeros_like(cost[0])
    _, out = jax.lax.scan(step, init, cost, reverse=reverse)
    return out


def aggregate_scan(cost: jnp.ndarray, p1: float, p2: float, num_paths: int = 4,
                   dtype=jnp.float32) -> jnp.ndarray:
    """Sum of directional SGM aggregations over 2, 4, or 8 paths.

    cost: (H, W, D) matching costs. Returns (H, W, D) float32.
    Paths: 2 = horizontal; 4 = + vertical; 8 = + both diagonals.
    ``dtype`` is the storage type (``StereoConfig.cost_dtype``): the costs
    and each direction's aggregation are rounded to it, and the directions
    are summed in float32 — what ``sgm_cuda.aggregate_cuda`` stores.
    """
    if num_paths not in (2, 4, 8):
        raise ValueError(f"num_paths must be 2, 4, or 8, got {num_paths}")
    cost = cost.astype(dtype).astype(jnp.float32)

    def path(c, reverse, shift=0):
        return _scan_path(c, p1, p2, reverse, shift).astype(dtype).astype(jnp.float32)

    # Horizontal: scan over W with lines of shape (H, D).
    cost_t = jnp.swapaxes(cost, 0, 1)  # (W, H, D)
    total = jnp.swapaxes(path(cost_t, False) + path(cost_t, True), 0, 1)
    if num_paths >= 4:
        # Vertical: scan over H with lines of shape (W, D).
        total = total + path(cost, False) + path(cost, True)
    if num_paths == 8:
        # Diagonals: the same vertical scan with a +-1 carry shift per step.
        for shift in (1, -1):
            total = total + path(cost, False, shift) + path(cost, True, shift)
    return total


def resolve_aggregation(choice: str, platform: str = "") -> str:
    """The implementation ``StereoConfig.aggregation`` names on ``platform``
    (default: JAX's default backend): "auto" is the CUDA kernel on a GPU and
    ``aggregate_scan`` anywhere else. "cuda" where no GPU is raises; nothing
    falls back quietly."""
    platform = platform or jax.default_backend()
    if choice == "auto":
        return "cuda" if platform == "gpu" else "scan"
    if choice == "cuda" and platform != "gpu":
        raise ValueError("stereo.aggregation='cuda' needs a CUDA GPU; the "
                         f"default backend is {platform!r}")
    return choice


def aggregate(cost: jnp.ndarray, config: StereoConfig) -> jnp.ndarray:
    """(H, W, D) matching costs -> (H, W, D) float32 path sums, by the
    implementation ``config.aggregation`` resolves to."""
    dtype = jnp.dtype(config.cost_dtype)
    if resolve_aggregation(config.aggregation) == "cuda":
        from online_3d_reconstruction.stereo.sgm_cuda import aggregate_cuda

        return aggregate_cuda(cost, config.p1, config.p2, config.num_paths, dtype)
    return aggregate_scan(cost, config.p1, config.p2, config.num_paths, dtype)


# ---------------------------------------------------------------------------
# WTA + uniqueness + subpixel
# ---------------------------------------------------------------------------

def wta_disparity(
    aggregated: jnp.ndarray,
    uniqueness_ratio: float = 0.95,
    subpixel: bool = True,
    fit: str = "parabola",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Winner-take-all over D (the last axis) with uniqueness gating and
    subpixel refinement.

    ``fit`` picks the subpixel interpolator: "parabola" (quadratic through the 3 costs around the
    minimum — what cv2's SGBM uses) or "vshape" (equiangular two-line fit:
    the true cost profile of census/SAD matching rises ~linearly near the
    minimum, so the quadratic systematically undershoots the offset and
    locks estimates toward integer disparities; the V fit assumes equal
    slopes and is the standard anti-pixel-locking interpolator). Returns
    (disparity (H, W) float32, valid (H, W) bool).
    """
    d_axis = aggregated.ndim - 1
    d = aggregated.shape[d_axis]
    # masked-min passes instead of take_along_axis gathers, so that XLA can
    # fuse all the reductions into one sweep of the volume
    best_idx = jnp.argmin(aggregated, axis=d_axis)
    best = jnp.min(aggregated, axis=d_axis).astype(jnp.float32)

    d_range = jax.lax.broadcasted_iota(jnp.int32, aggregated.shape, d_axis)
    off = d_range - jnp.expand_dims(best_idx, d_axis)   # signed offset from WTA
    second = jnp.min(jnp.where(jnp.abs(off) <= 1, _BIG, aggregated),
                     axis=d_axis).astype(jnp.float32)
    valid = best <= second * uniqueness_ratio

    disp = best_idx.astype(jnp.float32)
    if subpixel:
        c_m = jnp.min(jnp.where(off == -1, aggregated, _BIG),
                      axis=d_axis).astype(jnp.float32)
        c_p = jnp.min(jnp.where(off == 1, aggregated, _BIG),
                      axis=d_axis).astype(jnp.float32)
        if fit == "vshape":
            # equiangular: two lines of equal |slope| cross at the minimum;
            # offset = (c_m - c_p) / (2 (max(c_m, c_p) - best))
            denom = jnp.maximum(c_m, c_p) - best
            offset = jnp.where(denom > 1e-6, (c_m - c_p) / (2.0 * denom), 0.0)
        else:
            denom = c_m + c_p - 2.0 * best
            offset = jnp.where(denom > 1e-6, (c_m - c_p) / (2.0 * denom), 0.0)
        offset = jnp.clip(offset, -0.5, 0.5)
        interior = (best_idx > 0) & (best_idx < d - 1)
        disp = disp + jnp.where(interior, offset, 0.0)
    return disp, valid


def right_disparity_from_aggregated(aggregated: jnp.ndarray) -> jnp.ndarray:
    """Right-view integer WTA disparity from the *left* aggregated volume.

    aggR[y, x, d] = aggL[y, x + d, d] (the matching hypothesis linking right
    pixel x to left pixel x+d) — the standard trick cv2 uses for its LR check,
    requiring no second SGM pass.

    The shear along W indexed by d is gather-free: after swapping to
    (H, D, W), flat index dd*W + x + dd equals dd*(W+1) + x, so a pad and a
    reshape re-view the rows as sheared.
    """
    h, w, d = aggregated.shape
    agg_t = jnp.swapaxes(aggregated, 1, 2).reshape(h, d * w)
    agg_t = jnp.pad(agg_t, ((0, 0), (0, d)))
    sheared = agg_t.reshape(h, d, w + 1)[:, :, :w]  # [y, dd, x] = agg[y, x+dd, dd]
    oob = (jnp.arange(w, dtype=jnp.int32)[None, :]
           + jnp.arange(d, dtype=jnp.int32)[:, None]) >= w   # (D, W)
    agg_r = jnp.where(oob[None], _BIG, sheared)
    return jnp.argmin(agg_r, axis=1).astype(jnp.float32)


def lr_consistency_mask(disparity: jnp.ndarray, disp_right: jnp.ndarray,
                        max_diff: int = 1) -> jnp.ndarray:
    """Mask of left pixels whose right-view match agrees within max_diff."""
    w = disparity.shape[1]
    x = jnp.arange(w, dtype=jnp.float32)[None, :]
    xr = jnp.round(x - disparity).astype(jnp.int32)
    in_img = (xr >= 0) & (xr < w)
    d_r = jnp.take_along_axis(disp_right, jnp.clip(xr, 0, w - 1), axis=1)
    return in_img & (jnp.abs(d_r - disparity) <= max_diff)


def lr_consistency_mask_volume(disparity: jnp.ndarray, disp_right: jnp.ndarray,
                               max_disparity: int,
                               max_diff: int = 1) -> jnp.ndarray:
    """``lr_consistency_mask`` without the data-dependent gather.

    take_along_axis with data-dependent indices is a true gather. Instead
    build the constant-index shear RH[y, d, x] = disp_right[y, x-d] and
    select the d == round(disp) plane with a one-hot reduce: two fused
    passes of a (H, D, W) volume. (Chosen for the earlier target; not yet
    measured against the gather on the H100.)
    """
    h, w = disparity.shape
    d = max_disparity
    padded = jnp.concatenate(
        [jnp.full((h, d), -1e9, dtype=disp_right.dtype), disp_right], axis=1
    )  # (H, W + D)
    cols = (jnp.arange(w, dtype=jnp.int32)[None, :]
            - jnp.arange(d, dtype=jnp.int32)[:, None] + d)      # constant (D, W)
    rh = padded[:, cols]                                        # (H, D, W)
    d_round = jnp.clip(jnp.round(disparity), 0, d - 1).astype(jnp.int32)
    onehot = (jax.lax.broadcasted_iota(jnp.int32, (h, d, w), 1)
              == d_round[:, None, :])
    d_r = jnp.sum(jnp.where(onehot, rh, 0.0), axis=1)           # (H, W)
    xr = jnp.round(jnp.arange(w, dtype=jnp.float32)[None, :] - disparity)
    in_img = (xr >= 0) & (xr < w)
    return in_img & (jnp.abs(d_r - disparity) <= max_diff)


# ---------------------------------------------------------------------------
# Speckle filter (cv2.filterSpeckles semantics, on-device)
# ---------------------------------------------------------------------------

def speckle_filter(disparity: jnp.ndarray, valid: jnp.ndarray,
                   max_size: int, max_diff: float) -> jnp.ndarray:
    """Invalidate connected blobs of <= max_size pixels (cv2.filterSpeckles
    semantics; pixels are 4-connected when both are valid and their
    disparities differ by at most ``max_diff``). Returns the updated mask.

    Formulation — "run-cross mass" via segmented scans only:

        colrun(p) = length of p's maximal vertical connected run
        S1(p)     = sum of colrun(q) over p's maximal horizontal run
        S2(p)     = the transpose construction
        mass(p)   = max(S1, S2)

    The vertical runs crossing one horizontal run are column-disjoint, so
    every pixel counted by S1 is a distinct member of p's blob: mass is a
    LOWER bound on the exact blob size. Hence every pixel exact CC would
    invalidate (blob <= max_size) is invalidated here too — no speckle ever
    survives — while large regions keep mass ~ area. Only exotic thin
    staircase shapes can be over-removed (mass ~ 4 on a 1-px staircase);
    on terrain scenes the mask differs from converged CC labeling by
    <0.002% of pixels.

    Why not real connected components: exact CC needs either iterative
    label propagation (a data-dependent trip count) or scatter/gather count
    tables. This form is 8 one-axis segmented scans, no scatter, no gather,
    no labels, and a fixed amount of work per frame.
    """
    if max_size <= 0:
        return valid

    # Connectivity to the predecessor along each axis (x-1 for rows, y-1 for
    # columns); a cell NOT connected to its predecessor starts a new segment.
    def conn_prev(axis):
        a, b = (disparity, jnp.roll(disparity, 1, axis=axis))
        va, vb = (valid, jnp.roll(valid, 1, axis=axis))
        conn = va & vb & (jnp.abs(a - b) <= max_diff)
        idx = jnp.arange(disparity.shape[axis]) > 0
        return conn & idx.reshape((-1, 1) if axis == 0 else (1, -1))

    flags = [~conn_prev(0), ~conn_prev(1)]  # segment-start flags per axis

    # The scans carry int16 with SATURATING adds: the decision below is only
    # ``mass > max_size``, so any count that saturates far above max_size
    # decides identically, while 16-bit lanes halve the bytes all 8
    # log-depth scan sweeps move. Cap choice: fwd+bwd of two saturated
    # scans is <= 2*cap = 16384 (no int16 wrap), and the composition
    # subtracts at most one run (<= H+W), leaving a cap - (H+W) margin
    # above any usable max_size.
    cap = jnp.int16(8192)
    use_i16 = max_size < 4096
    dtype = jnp.int16 if use_i16 else jnp.int32

    def seg_sum(vals, flag, axis, reverse):
        """Inclusive segmented (saturating) sum-scan along one axis."""
        def combine(a, b):
            av, af = a
            bv, bf = b
            s = av + bv
            if use_i16:
                s = jnp.minimum(s, cap)
            return jnp.where(bf, bv, s), af | bf
        out, _ = jax.lax.associative_scan(
            combine, (vals, flag), axis=axis, reverse=reverse
        )
        return out

    def run_total(vals, axis):
        """Per pixel: sum of ``vals`` over its maximal run along ``axis``
        (forward-inclusive + backward-inclusive - self)."""
        flag = flags[axis]
        fwd = seg_sum(vals, flag, axis, reverse=False)
        rflag = jnp.roll(flag, -1, axis=axis)  # starts flip to run ends
        bwd = seg_sum(vals, rflag, axis, reverse=True)
        return fwd + bwd - vals

    ones = valid.astype(dtype)
    colrun = run_total(ones, axis=0)
    rowrun = run_total(ones, axis=1)
    mass = jnp.maximum(run_total(colrun, axis=1), run_total(rowrun, axis=0))
    return valid & (mass.astype(jnp.int32) > max_size)


# ---------------------------------------------------------------------------
# Full disparity pipeline
# ---------------------------------------------------------------------------

def disparity_from_aggregated(aggregated: jnp.ndarray, config: StereoConfig
                              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(H, W, D) path sums -> (disparity, valid) after WTA + uniqueness +
    subpixel and the LR check; the speckle filter is the caller's."""
    disp, valid = wta_disparity(aggregated, config.uniqueness_ratio,
                                config.subpixel, fit=config.subpixel_fit)
    if config.lr_max_diff >= 0:
        disp_r = right_disparity_from_aggregated(aggregated)
        valid = valid & lr_consistency_mask_volume(
            disp, disp_r, config.max_disparity, config.lr_max_diff)
    return disp, valid & (disp > 0.0)


@partial(jax.jit, static_argnames=("config",))
def sgm_disparity(left: jnp.ndarray, right: jnp.ndarray, config: StereoConfig
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Rectified grayscale pair -> (disparity (H, W) float32, valid (H, W) bool).

    The complete cv::StereoSGBM-equivalent stage: census cost, path
    aggregation (``aggregate``), WTA + uniqueness + subpixel, LR
    consistency, speckle filter. Invalid pixels carry
    ``config.invalid_value`` in the returned disparity.
    """
    cen_l = census_transform(left, config.census_window)
    cen_r = census_transform(right, config.census_window)
    cost = cost_volume(cen_l, cen_r, config.max_disparity)
    disp, valid = disparity_from_aggregated(aggregate(cost, config), config)
    if config.speckle_window > 0:
        valid = speckle_filter(disp, valid, config.speckle_window,
                               config.speckle_range)
    disp = jnp.where(valid, disp, config.invalid_value)
    return disp, valid
