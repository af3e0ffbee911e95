"""Validate the synthetic oracle itself: photometric stereo consistency."""

import numpy as np

from online_3d_reconstruction.utils.imaging import bilinear_sample_np


def test_stereo_photometric_consistency(stereo_frame):
    """left(u, v) must equal right(u - d_gt, v) wherever both are visible."""
    left, right, disp = stereo_frame.left, stereo_frame.right, stereo_frame.gt_disparity
    h, w = left.shape
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    resampled = bilinear_sample_np(right, u - disp, v, fill=np.nan)

    # Exclude occlusion bands near the plateau depth edges: a pixel is safe if
    # the local GT disparity is smooth (no discontinuity within 3 px).
    from scipy import ndimage  # scipy ships with the stack; gate if missing

    local_max = ndimage.maximum_filter(disp, size=7)
    local_min = ndimage.minimum_filter(disp, size=7)
    smooth = (local_max - local_min) < 0.75
    ok = smooth & np.isfinite(resampled)
    err = np.abs(left - resampled)[ok]
    assert ok.mean() > 0.5
    # The albedo now includes a non-band-limited speckle octave (sharp cell
    # edges), so bilinear resampling aliases at cell borders: the tail is
    # wider, but the bulk must stay tight.
    assert np.median(err) < 0.02, np.median(err)
    assert np.percentile(err, 95) < 0.15, np.percentile(err, 95)


def test_gt_disparity_range(stereo_frame, small_rig):
    disp = stereo_frame.gt_disparity
    # Ground at 24 m: d = 200 * 0.5 / 24 = 4.17; plateau top at 18 m: 5.56.
    assert disp.min() > 3.0
    assert disp.max() < 7.0
    near = small_rig.fx * small_rig.baseline / stereo_frame.depth.min()
    np.testing.assert_allclose(disp.max(), near, rtol=1e-5)


def test_depth_has_discontinuity(stereo_frame):
    depth = stereo_frame.depth
    assert depth.max() - depth.min() > 4.0  # plateau creates a 6 m step
