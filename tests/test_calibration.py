"""Calibration math vs the OpenCV oracle + functional epipolar checks."""

import numpy as np
import pytest

from online_3d_reconstruction.io.calibration import (
    CameraIntrinsics,
    StereoCalibration,
    init_undistort_rectify_map,
    stereo_rectify,
)

cv2 = pytest.importorskip("cv2")


def _rodrigues_exp(phi):
    theta = np.linalg.norm(phi)
    if theta < 1e-12:
        return np.eye(3)
    a = phi / theta
    skew = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(theta) * skew + (1 - np.cos(theta)) * (skew @ skew)


def test_undistort_rectify_map_matches_cv2():
    k = np.array([[310.0, 0, 160.0], [0, 305.0, 120.0], [0, 0, 1]])
    dist = (-0.28, 0.07, 1e-3, -5e-4, 0.0)
    r_rect = _rodrigues_exp(np.array([0.01, -0.02, 0.005]))
    p_new = np.array([[300.0, 0, 158.0, 0], [0, 300.0, 118.0, 0], [0, 0, 1, 0]])
    size = (320, 240)

    ours = init_undistort_rectify_map(k, dist, r_rect, p_new, size)
    mx, my = cv2.initUndistortRectifyMap(
        k, np.array(dist), r_rect, p_new, size, cv2.CV_32FC1
    )
    np.testing.assert_allclose(ours[..., 0], mx, atol=1e-2)
    np.testing.assert_allclose(ours[..., 1], my, atol=1e-2)


def _make_calib():
    left = CameraIntrinsics(fx=300.0, fy=298.0, cx=162.0, cy=118.0, width=320,
                            height=240, dist=(-0.2, 0.05, 1e-3, -1e-3, 0.0))
    right = CameraIntrinsics(fx=302.0, fy=301.0, cx=158.0, cy=122.0, width=320,
                             height=240, dist=(-0.22, 0.06, -1e-3, 5e-4, 0.0))
    rotation = _rodrigues_exp(np.array([0.004, -0.015, 0.006]))
    translation = np.array([-0.24, 0.002, -0.004])
    return StereoCalibration(left=left, right=right, rotation=rotation,
                             translation=translation)


def test_stereo_rectify_epipolar_alignment():
    """After rectification, a 3D point projects to the same row in both views
    and its disparity equals fx * B / Z."""
    calib = _make_calib()
    rig = stereo_rectify(calib)

    rng = np.random.default_rng(0)
    pts_left = np.stack(
        [rng.uniform(-3, 3, 40), rng.uniform(-2, 2, 40), rng.uniform(6, 30, 40)],
        axis=1,
    )  # points in the *left camera* frame

    def project(pts, r_rect, p):
        cam = pts @ r_rect.T
        uv = cam @ p[:3, :3].T + p[:3, 3]
        return uv[:, :2] / uv[:, 2:3], cam[:, 2]

    uv_l, z_l = project(pts_left, rig.r1, rig.p1)
    pts_right = pts_left @ calib.rotation.T + calib.translation
    # The remap uses only P2's 3x3 new-camera part; the 4th (baseline) column
    # applies when projecting left-frame points, not right-frame ones.
    p2_cam = rig.p2.copy()
    p2_cam[0, 3] = 0.0
    uv_r, _ = project(pts_right, rig.r2, p2_cam)

    # Same scanline in both rectified views.
    np.testing.assert_allclose(uv_l[:, 1], uv_r[:, 1], atol=5e-3)
    # Disparity consistent with the rectified depth.
    disparity = uv_l[:, 0] - uv_r[:, 0]
    np.testing.assert_allclose(disparity, rig.fx * rig.baseline / z_l, rtol=1e-4)
    assert (disparity > 0).all()


def test_rectified_rotations_are_rotations():
    rig = stereo_rectify(_make_calib())
    for rot in (rig.r1, rig.r2):
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-10)
        assert abs(np.linalg.det(rot) - 1.0) < 1e-10


def test_q_matrix_roundtrip():
    rig = stereo_rectify(_make_calib())
    z = 12.0
    d = rig.fx * rig.baseline / z
    u, v = 100.0, 80.0
    vec = rig.q @ np.array([u, v, d, 1.0])
    xyz = vec[:3] / vec[3]
    assert abs(xyz[2] - z) < 1e-6


class TestBandedRemap:
    """remap_bilinear_banded == remap_bilinear (the hot-path matmul form must be
    exactly the bilinear gather it replaces, OOB/fill semantics included)."""

    def _rig(self):
        cam = CameraIntrinsics(fx=100.0, fy=100.0, cx=64.0, cy=48.0,
                               width=128, height=96,
                               dist=(-0.25, 0.08, 0.001, -0.001, 0.0))
        calib = StereoCalibration(left=cam, right=cam,
                                  translation=np.array([-0.2, 0.01, 0.0]))
        return stereo_rectify(calib)

    def test_matches_gather_gray_and_color(self):
        import jax.numpy as jnp

        from online_3d_reconstruction.stereo.rectify import (
            remap_bilinear,
            remap_bilinear_banded,
            vertical_band,
        )

        rng = np.random.default_rng(0)
        rig = self._rig()
        for shape in [(96, 128), (96, 128, 3)]:
            img = rng.random(shape).astype(np.float32)
            for m in (rig.map_left, rig.map_right):
                band = vertical_band(m)
                a = np.asarray(remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
                b = np.asarray(remap_bilinear_banded(jnp.asarray(img),
                                                     jnp.asarray(m), band))
                np.testing.assert_allclose(a, b, atol=1e-5)

    def test_matches_gather_wild_map_with_oob(self):
        import jax.numpy as jnp

        from online_3d_reconstruction.stereo.rectify import (
            remap_bilinear,
            remap_bilinear_banded,
            vertical_band,
        )

        rng = np.random.default_rng(1)
        img = rng.random((64, 96)).astype(np.float32)
        # random map spilling outside the image exercises fill semantics;
        # sorting rows keeps the vertical band finite but large
        m = (rng.random((64, 96, 2)).astype(np.float32)
             * np.array([110.0, 80.0], np.float32) - 8.0)
        m.sort(axis=0)
        band = vertical_band(m)
        a = np.asarray(remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
        b = np.asarray(remap_bilinear_banded(jnp.asarray(img), jnp.asarray(m),
                                             band))
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_band_cap_degenerates_to_full_height(self):
        import jax.numpy as jnp

        from online_3d_reconstruction.stereo.rectify import (
            remap_bilinear,
            remap_bilinear_banded,
        )

        rng = np.random.default_rng(2)
        img = rng.random((32, 48)).astype(np.float32)
        m = (rng.random((32, 48, 2)).astype(np.float32)
             * np.array([46.0, 30.0], np.float32))
        a = np.asarray(remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
        b = np.asarray(remap_bilinear_banded(jnp.asarray(img), jnp.asarray(m),
                                             band=999))
        np.testing.assert_allclose(a, b, atol=1e-5)
