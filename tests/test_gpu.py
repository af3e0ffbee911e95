"""The CUDA SGM aggregation kernel on a GPU, against its reference.

Every test here takes the ``gpu`` fixture and is skipped where JAX's
default backend is not a GPU. Run them on the card with

    python -m pytest -m gpu tests/

They are the checks of ``chip_smoke.py``'s kernel and disparity phases:
the kernel against ``aggregate_scan`` at the bench's 384x512xD64 for each
path count and storage type, and at a KITTI-shaped 376x1241xD128 (odd
width, D = 4 per lane), then the whole disparity stage against the
synthetic scene's ground truth.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from online_3d_reconstruction.config import StereoConfig
from online_3d_reconstruction.stereo.sgm import aggregate_scan, sgm_disparity
from online_3d_reconstruction.stereo.sgm_cuda import aggregate_cuda

pytestmark = pytest.mark.gpu


def _cost(shape, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 25, shape).astype(np.float32))


def _reference(cost, num_paths, dtype=jnp.float32):
    with jax.default_matmul_precision("highest"):
        return np.asarray(aggregate_scan(cost, 8.0, 32.0, num_paths, dtype))


@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_kernel_matches_scan_f32(gpu, num_paths):
    """Census costs are integers, so float32 sums are exact: <= 1e-3."""
    cost = _cost((384, 512, 64), 0)
    got = np.asarray(aggregate_cuda(cost, 8.0, 32.0, num_paths, jnp.float32))
    assert np.abs(got - _reference(cost, num_paths)).max() <= 1e-3


def test_kernel_bf16_wta_agreement(gpu):
    """bfloat16 storage: the WTA argmin agrees with the float32 reference
    on all but < 0.5% of pixels (StereoConfig.cost_dtype's tolerance)."""
    cost = _cost((384, 512, 64), 1)
    got = np.asarray(aggregate_cuda(cost, 8.0, 32.0, 8, jnp.bfloat16))
    want = _reference(cost, 8)
    assert (got.argmin(-1) != want.argmin(-1)).mean() < 0.005


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kernel_kitti_shape(gpu, dtype):
    """376x1241xD128: an odd width and four disparities per lane."""
    cost = _cost((376, 1241, 128), 2)
    got = np.asarray(aggregate_cuda(cost, 8.0, 32.0, 8, dtype))
    assert np.abs(got - _reference(cost, 8, dtype)).max() <= 1e-3


def test_sgm_disparity_quality(gpu):
    """The whole stage (census -> CUDA aggregation -> WTA/LR/speckle) on the
    synthetic scene at 512x384, D64, 8 paths, against its ground truth."""
    from online_3d_reconstruction.io.calibration import identity_rig
    from online_3d_reconstruction.io.synthetic import SyntheticScene, nadir_pose

    h, w = 384, 512
    rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, baseline=0.5,
                       width=w, height=h)
    frame = SyntheticScene(seed=3).render_stereo(nadir_pose(0.0, 0.0, 30.0), rig)
    cfg = StereoConfig(height=h, width=w, max_disparity=64, num_paths=8,
                       aggregation="cuda")
    disp, valid = sgm_disparity(jnp.asarray(frame.left),
                                jnp.asarray(frame.right), cfg)
    disp, valid = np.asarray(disp), np.asarray(valid)
    ok = valid & (frame.gt_disparity > 0)
    assert ok.mean() > 0.9
    assert (np.abs(disp[ok] - frame.gt_disparity[ok]) > 1.0).mean() < 0.02
