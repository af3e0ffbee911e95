"""FAST/BRIEF feature tests: detection vs cv2.FAST, descriptor sanity."""

import numpy as np
import pytest

import jax.numpy as jnp

from online_3d_reconstruction.config import FeatureConfig
from online_3d_reconstruction.features.brief import (
    brief_pattern,
    describe_keypoints,
    detect_and_describe,
)
from online_3d_reconstruction.features.fast import detect_keypoints, fast_score
from online_3d_reconstruction.utils.imaging import to_uint8


# the synthetic scene texture is smooth; threshold 5/255 yields ~800 corners
CFG = FeatureConfig(max_keypoints=256, fast_threshold=5.0)


class TestFast:
    def test_blank_image_no_corners(self):
        xy, score, valid = detect_keypoints(jnp.zeros((64, 64)), max_keypoints=64)
        assert not np.asarray(valid).any()

    def test_single_bright_dot_detected(self):
        img = np.zeros((64, 64), dtype=np.float32)
        img[32, 32] = 1.0
        xy, score, valid = detect_keypoints(jnp.asarray(img), max_keypoints=16,
                                            border=8)
        v = np.asarray(valid)
        assert v.any()
        best = np.asarray(xy)[0]
        assert tuple(best) == (32.0, 32.0)

    def test_agreement_with_cv2_fast(self, stereo_frame):
        """Raw corner set: cv2.FAST corners are a subset of ours.

        Run both on the identical uint8-quantized image, NMS off. Our float
        comparison admits a few extra ties exactly at the threshold boundary
        (cv2's int test is strict), so we assert cv2 ⊆ ours and bound the
        tie-break surplus.
        """
        cv2 = pytest.importorskip("cv2")
        q8 = to_uint8(stereo_frame.left)
        img = q8.astype(np.float32) / 255.0
        score = np.asarray(fast_score(jnp.asarray(img), 5.0 / 255.0, 9))
        ours = set(map(tuple, np.argwhere(score > 0)))

        det = cv2.FastFeatureDetector_create(threshold=5, nonmaxSuppression=False)
        ref = set((int(k.pt[1]), int(k.pt[0])) for k in det.detect(q8))
        assert len(ref) > 100
        missing = ref - ours
        assert not missing, f"{len(missing)} cv2 corners we missed"
        surplus = len(ours - ref) / max(len(ref), 1)
        assert surplus < 0.2, f"tie-break surplus {surplus:.2f}"

    def test_tiled_retention_spreads_keypoints(self, stereo_frame):
        xy, _, valid = detect_keypoints(
            jnp.asarray(stereo_frame.left), max_keypoints=256, threshold=5.0 / 255.0,
            grid_tiles=(4, 4)
        )
        pts = np.asarray(xy)[np.asarray(valid)]
        h, w = stereo_frame.left.shape
        # keypoints appear in at least half of the 16 tiles
        tiles = set(zip((pts[:, 1] // (h / 4)).astype(int), (pts[:, 0] // (w / 4)).astype(int)))
        assert len(tiles) >= 8


class TestBrief:
    def test_pattern_deterministic_and_bounded(self):
        p1 = brief_pattern(256, 31, seed=7)
        p2 = brief_pattern(256, 31, seed=7)
        np.testing.assert_array_equal(p1, p2)
        assert np.abs(p1).max() <= 31 // 2 - 2

    def test_descriptors_packed_shape(self, stereo_frame):
        kp = detect_and_describe(jnp.asarray(stereo_frame.left), CFG)
        assert kp.descriptors.shape == (256, 256 // 32)
        assert kp.descriptors.dtype == jnp.uint32
        assert np.asarray(kp.valid).sum() > 50

    def test_descriptor_stable_under_noise(self, stereo_frame):
        """Tiny intensity noise flips few descriptor bits (Hamming << bits/2)."""
        rng = np.random.default_rng(0)
        img = stereo_frame.left
        kp1 = detect_and_describe(jnp.asarray(img), CFG)
        noisy = img + rng.normal(0, 0.01, img.shape).astype(np.float32)
        kp2 = describe_keypoints(jnp.asarray(noisy), kp1.xy, kp1.score, kp1.valid, CFG)
        both = np.asarray(kp1.valid)
        d1 = np.asarray(kp1.descriptors)[both]
        d2 = np.asarray(kp2.descriptors)[both]
        ham = np.array([bin(int(a) ^ int(b)).count("1") for a, b in
                        zip(d1.reshape(-1).tolist(), d2.reshape(-1).tolist())])
        mean_bits = ham.reshape(len(d1), -1).sum(axis=1).mean()
        assert mean_bits < 40, f"mean Hamming under noise: {mean_bits}"


class TestPyramid:
    def test_levels_populated_and_coords_full_res(self, stereo_frame):
        cfg = FeatureConfig(max_keypoints=256, fast_threshold=5.0, num_levels=3)
        kp = detect_and_describe(jnp.asarray(stereo_frame.left), cfg)
        oct_np = np.asarray(kp.octave)
        valid = np.asarray(kp.valid)
        assert kp.xy.shape == (256, 2)
        assert set(np.unique(oct_np[valid])) >= {0, 1}
        h, w = stereo_frame.left.shape
        pts = np.asarray(kp.xy)[valid]
        assert (pts[:, 0] < w).all() and (pts[:, 1] < h).all()

    def test_scale_robust_matching(self, scene, small_rig):
        """Same terrain at 1.5x altitude: pyramid matching finds more pairs."""
        from online_3d_reconstruction.features.match import match_descriptors
        from online_3d_reconstruction.io.synthetic import nadir_pose

        f1 = scene.render_stereo(nadir_pose(0, 0, 20.0), small_rig)
        f2 = scene.render_stereo(nadir_pose(0, 0, 30.0), small_rig)

        def n_matches(levels):
            cfg = FeatureConfig(max_keypoints=256, fast_threshold=5.0,
                                num_levels=levels)
            a = detect_and_describe(jnp.asarray(f1.left), cfg)
            b = detect_and_describe(jnp.asarray(f2.left), cfg)
            m = match_descriptors(a.descriptors, b.descriptors, a.valid, b.valid)
            return int(np.asarray(m.valid).sum())

        single = n_matches(1)
        pyr = n_matches(3)
        assert pyr >= single, (single, pyr)


class TestSubpixel:
    """Score-surface subpixel refinement (features/fast.refine_subpixel_score).

    Integer FAST detections quantize to +-0.5 px frame-correlated error —
    the measured dominant BA observation term; the parabola fit must (a)
    recover known fractional peak positions and (b) make detections of the
    same content more consistent under subpixel image translation.
    """

    def test_recovers_fractional_blob_center(self):
        h, w = 64, 64
        yy, xx = np.meshgrid(np.arange(h, dtype=np.float64),
                             np.arange(w, dtype=np.float64), indexing="ij")
        errs_int, errs_sub = [], []
        for (cy, cx) in [(30.3, 31.6), (24.8, 40.25), (40.1, 22.7)]:
            img = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 1.8 ** 2))
            xy_i, _, v_i = detect_keypoints(jnp.asarray(img.astype(np.float32)),
                                            max_keypoints=4, border=5)
            xy_s, _, v_s = detect_keypoints(jnp.asarray(img.astype(np.float32)),
                                            max_keypoints=4, border=5,
                                            subpixel=True)
            assert bool(np.asarray(v_i)[0]) and bool(np.asarray(v_s)[0])
            errs_int.append(np.linalg.norm(np.asarray(xy_i)[0] - [cx, cy]))
            errs_sub.append(np.linalg.norm(np.asarray(xy_s)[0] - [cx, cy]))
        assert np.mean(errs_sub) < 0.2
        assert np.mean(errs_sub) < 0.6 * np.mean(errs_int)

    def test_translation_consistency_on_scene(self, small_rig):
        from online_3d_reconstruction.io.synthetic import (
            SyntheticScene,
            nadir_pose,
        )

        scene = SyntheticScene(seed=11, supersample=2)
        alt = 24.0
        dx_m = 0.03   # -> fx * dx / alt = 0.25 px image shift
        shift_px = small_rig.fx * dx_m / alt
        f1 = scene.render_stereo(nadir_pose(0.0, 0.0, alt), small_rig)
        f2 = scene.render_stereo(nadir_pose(dx_m, 0.0, alt), small_rig)

        def detect(img, subpixel):
            xy, _, v = detect_keypoints(jnp.asarray(img), max_keypoints=256,
                                        threshold=5.0 / 255.0,
                                        subpixel=subpixel)
            return np.asarray(xy)[np.asarray(v)]

        def shift_err(sub):
            a = detect(f1.left, sub)
            b = detect(f2.left, sub)
            # same content appears shift_px to the LEFT in f2 (camera moved
            # +x); associate nearest neighbors and measure the residual
            target = a - np.array([shift_px, 0.0])
            d = np.linalg.norm(target[:, None, :] - b[None, :, :], axis=-1)
            j = d.argmin(axis=1)
            ok = d[np.arange(len(a)), j] < 1.0
            resid = target[ok] - b[j[ok]]
            return float(np.sqrt((resid ** 2).sum(axis=1).mean())), int(ok.sum())

        err_int, n_int = shift_err(False)
        err_sub, n_sub = shift_err(True)
        assert n_int > 50 and n_sub > 50
        # subpixel detections must track the true fractional shift better
        # than integer ones re-quantizing to the grid
        assert err_sub < err_int
        assert err_sub < 0.35
