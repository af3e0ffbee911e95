"""SGM disparity: brute-force recurrences, ground truth, cv2 cross-check.

The reference's disparity comes from cv::StereoSGBM (SURVEY.md §2.1 C5); it
ships no tests, so the oracles here are (a) literal per-pixel recurrences,
(b) the synthetic scene's analytic disparity and (c) cv2.StereoSGBM
agreement (§4.1). The CUDA aggregation kernel has no CPU mode: here its
path table is walked by a numpy recurrence, and its choice, bounds and
wrapper are checked; tests/test_gpu.py compares the kernel itself with
``aggregate_scan`` on a GPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from online_3d_reconstruction.config import StereoConfig
from online_3d_reconstruction.stereo.sgm import (
    aggregate,
    aggregate_scan,
    resolve_aggregation,
    right_disparity_from_aggregated,
    sgm_disparity,
    speckle_filter,
    wta_disparity,
)
from online_3d_reconstruction.stereo.sgm_cuda import (
    DIRECTIONS,
    aggregate_cuda,
    path_table,
)
from online_3d_reconstruction.utils.imaging import to_uint8


def _cfg(**kw):
    base = dict(
        height=192, width=256, max_disparity=32, num_paths=4,
        speckle_window=50,
    )
    base.update(kw)
    return StereoConfig(**base)


def _brute_direction(cost, p1, p2, dy, dx):
    """Literal per-pixel SGM recurrence along direction (dy, dx)."""
    h, w, d = cost.shape
    out = np.zeros_like(cost)
    ys = range(h) if dy >= 0 else range(h - 1, -1, -1)
    xs = range(w) if dx >= 0 else range(w - 1, -1, -1)
    for y in ys:
        for x in xs:
            py, px = y - dy, x - dx
            if 0 <= py < h and 0 <= px < w:
                prev = out[py, px]
                mp = prev.min()
                for dd in range(d):
                    c = [prev[dd], mp + p2]
                    if dd > 0:
                        c.append(prev[dd - 1] + p1)
                    if dd < d - 1:
                        c.append(prev[dd + 1] + p1)
                    out[y, x, dd] = cost[y, x, dd] + min(c) - mp
            else:
                out[y, x] = cost[y, x]
    return out


def _walk_path_table(cost, table, p1, p2, num_paths):
    """The CUDA kernel's traversal in numpy: every row of the path table is
    one warp's chain. Returns the (P, H, W, D) planes and how often each
    pixel was visited per direction."""
    h, w, d = cost.shape
    flat = cost.reshape(h * w, d)
    planes = np.zeros((num_paths, h * w, d), np.float32)
    visits = np.zeros((num_paths, h * w), np.int32)
    for start, stride, length, k in table:
        prev = np.zeros(d, np.float32)          # fresh start: L = C
        for s in range(length):
            p = start + s * stride
            mp = prev.min()
            dm = np.concatenate([[1e9], prev[:-1]])
            dp = np.concatenate([prev[1:], [1e9]])
            best = np.minimum(np.minimum(prev, mp + p2),
                              np.minimum(dm + p1, dp + p1))
            prev = flat[p] + best - mp
            planes[k, p] = prev
            visits[k, p] += 1
    return planes.reshape(num_paths, h, w, d), visits


def _bad_fraction(disp, valid, gt, tol=1.0):
    disp = np.asarray(disp)
    valid = np.asarray(valid)
    gt = np.asarray(gt)
    mask = valid & np.isfinite(gt)
    assert mask.sum() > 0
    return np.mean(np.abs(disp[mask] - gt[mask]) > tol), mask.mean()


class TestAggregation:
    def test_scan_matches_bruteforce_1d(self):
        """One row, tiny D: compare against a literal python SGM recurrence."""
        rng = np.random.default_rng(0)
        cost = rng.integers(0, 20, size=(1, 7, 4)).astype(np.float32)
        p1, p2 = 2.0, 8.0
        agg = np.asarray(aggregate_scan(jnp.asarray(cost), p1, p2, num_paths=2))

        # forward direction, hand-rolled
        fwd = np.zeros_like(cost[0])
        prev = np.zeros(4)
        for x in range(7):
            mp = prev.min()
            for d in range(4):
                cands = [prev[d], mp + p2]
                if d > 0:
                    cands.append(prev[d - 1] + p1)
                if d < 3:
                    cands.append(prev[d + 1] + p1)
                fwd[x, d] = cost[0, x, d] + min(cands) - mp
            prev = fwd[x].copy()
        bwd = np.zeros_like(cost[0])
        prev = np.zeros(4)
        for x in range(6, -1, -1):
            mp = prev.min()
            for d in range(4):
                cands = [prev[d], mp + p2]
                if d > 0:
                    cands.append(prev[d - 1] + p1)
                if d < 3:
                    cands.append(prev[d + 1] + p1)
                bwd[x, d] = cost[0, x, d] + min(cands) - mp
            prev = bwd[x].copy()
        np.testing.assert_allclose(agg[0], fwd + bwd, rtol=1e-5)

    @pytest.mark.parametrize("num_paths", [2, 4, 8])
    def test_scan_matches_bruteforce(self, num_paths):
        """The reference for every path count against the literal
        recurrence summed over that count's directions."""
        rng = np.random.default_rng(1)
        cost = rng.integers(0, 24, size=(9, 13, 6)).astype(np.float32)
        gt = sum(_brute_direction(cost, 8.0, 32.0, dy, dx)
                 for dy, dx in DIRECTIONS[:num_paths])
        agg = np.asarray(aggregate_scan(jnp.asarray(cost), 8.0, 32.0, num_paths))
        np.testing.assert_allclose(agg, gt, rtol=1e-5)

    @pytest.mark.parametrize("num_paths", [2, 4, 8])
    def test_path_table_walk_matches_scan(self, num_paths):
        """The CUDA kernel's chains (sgm_cuda.path_table), walked by the same
        recurrence, cover every pixel once per direction and reproduce
        ``aggregate_scan`` — on odd shapes, tall and wide."""
        rng = np.random.default_rng(2)
        for h, w in ((7, 11), (12, 5), (1, 6)):
            cost = rng.integers(0, 24, size=(h, w, 5)).astype(np.float32)
            table = path_table(h, w, num_paths)
            planes, visits = _walk_path_table(cost, table, 8.0, 32.0, num_paths)
            assert (visits == 1).all()
            assert (np.diff(table[:, 2]) <= 0).all()   # longest chains first
            ref = np.asarray(aggregate_scan(jnp.asarray(cost), 8.0, 32.0,
                                            num_paths))
            np.testing.assert_allclose(planes.sum(0), ref, rtol=1e-6)

    def test_diagonals_match_bruteforce(self):
        """Each diagonal direction alone, in the reference and in the CUDA
        kernel's path table, vs a literal per-pixel recurrence — in
        particular the fresh-start borders, which an earlier
        skew-the-volume formulation got subtly wrong (pad cells leaked a
        d-dependent residual into restarts)."""
        rng = np.random.default_rng(3)
        h, w, d = 10, 12, 4
        cost = rng.integers(0, 24, size=(h, w, d)).astype(np.float32)
        p1, p2 = 8.0, 32.0
        brute = [_brute_direction(cost, p1, p2, dy, dx) for dy, dx in DIRECTIONS]
        agg = np.asarray(aggregate_scan(jnp.asarray(cost), p1, p2, 8))
        np.testing.assert_allclose(agg, sum(brute), rtol=1e-5)
        planes, _ = _walk_path_table(cost, path_table(h, w, 8), p1, p2, 8)
        for k in range(4, 8):   # the diagonal planes
            np.testing.assert_allclose(planes[k], brute[k], rtol=1e-5)

    def test_aggregated_sums_within_storage_bound(self):
        """Each direction's value is at most C_max + P2 (the recurrence
        subtracts the previous minimum), so a path sum is at most
        num_paths * (C_max + P2): with census costs <= 32 and P2 = 32 every
        per-direction value is an integer <= 64, exact in bfloat16 (exact to
        256), and 8-path sums stay far inside float32's exact integers."""
        rng = np.random.default_rng(4)
        cost = np.where(rng.random((16, 24, 8)) < 0.5, 32.0, 0.0).astype(np.float32)
        p1, p2 = 8.0, 32.0
        for dy, dx in DIRECTIONS:
            plane = _brute_direction(cost, p1, p2, dy, dx)
            assert plane.min() >= 0 and plane.max() <= 32 + p2
        agg = np.asarray(aggregate_scan(jnp.asarray(cost), p1, p2, 8))
        assert agg.max() <= 8 * (32 + p2)
        np.testing.assert_array_equal(agg, np.round(agg))
        bf16 = np.asarray(aggregate_scan(jnp.asarray(cost), p1, p2, 8,
                                         dtype=jnp.bfloat16))
        np.testing.assert_array_equal(bf16, agg)
        # odd values past bfloat16's exact integers make storage round
        odd = jnp.asarray((rng.integers(128, 300, (16, 24, 8)) * 2 + 1)
                          .astype(np.float32))
        big = np.asarray(aggregate_scan(odd, p1, p2, 8, dtype=jnp.bfloat16))
        ref = np.asarray(aggregate_scan(odd, p1, p2, 8))
        assert np.abs(big - ref).max() > 0


class TestAggregationChoice:
    def test_auto_resolves_per_platform(self):
        assert resolve_aggregation("auto", "gpu") == "cuda"
        assert resolve_aggregation("auto", "cpu") == "scan"
        assert resolve_aggregation("scan", "gpu") == "scan"
        assert resolve_aggregation("cuda", "gpu") == "cuda"
        assert resolve_aggregation("auto") == "scan"    # this CPU process

    def test_cuda_without_gpu_raises_naming_the_field(self, stereo_frame):
        with pytest.raises(ValueError, match="stereo.aggregation"):
            resolve_aggregation("cuda", "cpu")
        with pytest.raises(ValueError, match="stereo.aggregation"):
            sgm_disparity(jnp.asarray(stereo_frame.left),
                          jnp.asarray(stereo_frame.right),
                          _cfg(aggregation="cuda"))

    def test_config_rejects_unknown_aggregation(self):
        with pytest.raises(ValueError, match="stereo.aggregation"):
            StereoConfig(aggregation="pallas")

    def test_aggregate_dispatches_to_scan_on_cpu(self):
        rng = np.random.default_rng(5)
        cost = jnp.asarray(rng.integers(0, 24, size=(6, 9, 8)).astype(np.int32))
        cfg = _cfg(max_disparity=8, num_paths=8, cost_dtype="float32")
        np.testing.assert_array_equal(
            np.asarray(aggregate(cost, cfg)),
            np.asarray(aggregate_scan(cost, cfg.p1, cfg.p2, 8)))

    def test_cuda_wrapper_rejects_wide_disparity_range(self):
        with pytest.raises(ValueError, match="D <= 256"):
            aggregate_cuda(jnp.zeros((4, 4, 288)), 8.0, 32.0, 8)


class TestWTA:
    def test_wta_picks_min_and_subpixel_in_range(self):
        rng = np.random.default_rng(2)
        agg = jnp.asarray(rng.uniform(1, 100, size=(8, 8, 16)).astype(np.float32))
        disp, valid = wta_disparity(agg, uniqueness_ratio=1.0, subpixel=True)
        idx = np.argmin(np.asarray(agg), axis=-1)
        assert np.all(np.abs(np.asarray(disp) - idx) <= 0.5)

    def test_uniqueness_kills_flat_cost(self):
        agg = jnp.ones((4, 4, 16), dtype=jnp.float32)
        _, valid = wta_disparity(agg, uniqueness_ratio=0.95, subpixel=False)
        assert not np.asarray(valid).any()

    def test_right_disparity_shift(self):
        """A volume whose min is at d0 everywhere maps right-view min to d0."""
        h, w, d = 6, 32, 8
        agg = np.full((h, w, d), 50.0, dtype=np.float32)
        agg[:, :, 3] = 1.0
        d_r = np.asarray(right_disparity_from_aggregated(jnp.asarray(agg)))
        assert np.all(d_r[:, : w - d] == 3)


class TestSpeckle:
    def test_small_blob_removed_large_kept(self):
        disp = np.zeros((32, 32), dtype=np.float32)
        disp[:, :16] = 10.0      # big region, half the image
        disp[2:4, 20:22] = 10.0  # 4-pixel speckle in a sea of zeros
        valid = np.ones_like(disp, dtype=bool)
        out = np.asarray(
            speckle_filter(jnp.asarray(disp), jnp.asarray(valid), 20, 1.0)
        )
        assert out[:, :16].all()          # 512-pixel blob survives
        assert not out[2:4, 20:22].any()  # 4-pixel blob dies
        assert out[:, 16:].sum() + 4 == (32 * 16)  # zero-region blob survives

    def test_matches_numpy_run_cross_mass(self):
        """The associative-scan form against a literal numpy walk of the
        same run-cross-mass definition (row and column runs of connected
        valid pixels), bit for bit, including the int16 saturating scans."""
        def runs(conn_prev, vals, axis):
            v = np.moveaxis(vals, axis, 0)
            c = np.moveaxis(conn_prev, axis, 0)
            out = np.zeros_like(v)
            for j in range(v.shape[1]):
                i = 0
                while i < v.shape[0]:
                    e = i + 1
                    while e < v.shape[0] and c[e, j]:
                        e += 1
                    out[i:e, j] = v[i:e, j].sum()
                    i = e
            return np.moveaxis(out, 0, axis)

        rng = np.random.default_rng(7)
        for h, w in ((64, 128), (96, 256)):
            disp = np.round(rng.uniform(0, 30, (h, w)) / 6) * 6
            disp = (disp + rng.normal(0, 0.2, (h, w))).astype(np.float32)
            valid = rng.random((h, w)) > 0.15
            conn = []
            for axis in (0, 1):
                d_prev = np.roll(disp, 1, axis=axis)
                v_prev = np.roll(valid, 1, axis=axis)
                c = valid & v_prev & (np.abs(disp - d_prev) <= 1.0)
                if axis == 0:
                    c[0, :] = False
                else:
                    c[:, 0] = False
                conn.append(c)
            ones = valid.astype(np.int64)
            colrun = runs(conn[0], ones, 0)
            rowrun = runs(conn[1], ones, 1)
            mass = np.maximum(runs(conn[1], colrun, 1), runs(conn[0], rowrun, 0))
            want = valid & (mass > 50)
            got = speckle_filter(jnp.asarray(disp), jnp.asarray(valid), 50, 1.0)
            np.testing.assert_array_equal(np.asarray(got), want)

    def test_disabled(self):
        disp = jnp.zeros((8, 8))
        valid = jnp.ones((8, 8), dtype=bool)
        out = speckle_filter(disp, valid, 0, 1.0)
        assert np.asarray(out).all()

    def test_agreement_with_cv2_filter_speckles(self, stereo_frame):
        """Oracle: cv2.filterSpeckles (exact connected components) on a real
        disparity map. The run-cross mass is a LOWER bound on blob size, so
        every pixel exact CC removes must be removed here too (no surviving
        speckles); only rare thin shapes may be over-removed."""
        cv2 = pytest.importorskip("cv2")
        cfg = _cfg(speckle_window=0)
        disp, valid = sgm_disparity(
            jnp.asarray(stereo_frame.left), jnp.asarray(stereo_frame.right), cfg
        )
        disp = np.asarray(disp)
        valid = np.asarray(valid)
        ours = np.asarray(
            speckle_filter(jnp.asarray(disp), jnp.asarray(valid), 50, 1.0)
        )
        fx = np.where(valid, np.round(disp * 16), -256).astype(np.int16)
        cv2.filterSpeckles(fx, -256, 50, 16)  # max_diff 1.0 px == 16 units
        ref = (fx != -256) & valid
        missed = (~ref & ours).mean()        # speckle survived: must be ~0
        over_removed = (ref & ~ours).mean()  # lower-bound over-removal: rare
        assert missed < 0.001, f"surviving speckles {missed:.5f}"
        assert over_removed < 0.005, f"over-removal {over_removed:.5f}"


class TestEndToEnd:
    def test_disparity_vs_ground_truth(self, scene, small_rig, stereo_frame):
        cfg = _cfg()
        disp, valid = sgm_disparity(
            jnp.asarray(stereo_frame.left), jnp.asarray(stereo_frame.right), cfg
        )
        bad, density = _bad_fraction(disp, np.asarray(valid), stereo_frame.gt_disparity)
        assert density > 0.5, f"valid density too low: {density}"
        assert bad < 0.10, f"bad-pixel rate too high: {bad}"

    def test_auto_choice_matches_explicit_scan(self, stereo_frame):
        """On the CPU the default choice is the reference itself."""
        left = jnp.asarray(stereo_frame.left)
        right = jnp.asarray(stereo_frame.right)
        d_auto, v_auto = sgm_disparity(left, right, _cfg())
        d_scan, v_scan = sgm_disparity(left, right, _cfg(aggregation="scan"))
        np.testing.assert_array_equal(np.asarray(v_auto), np.asarray(v_scan))
        np.testing.assert_array_equal(np.asarray(d_auto), np.asarray(d_scan))

    def test_agreement_with_cv2_sgbm(self, stereo_frame):
        """Census-SGM and cv2's BT-SGBM should agree on most valid pixels."""
        cv2 = pytest.importorskip("cv2")
        cfg = _cfg(num_paths=8)
        disp, valid = sgm_disparity(
            jnp.asarray(stereo_frame.left), jnp.asarray(stereo_frame.right), cfg
        )
        sgbm = cv2.StereoSGBM_create(
            minDisparity=0, numDisparities=32, blockSize=5,
            P1=8 * 25, P2=32 * 25, uniquenessRatio=5,
            speckleWindowSize=50, speckleRange=2, disp12MaxDiff=1,
            mode=cv2.STEREO_SGBM_MODE_HH,
        )
        ref = sgbm.compute(to_uint8(stereo_frame.left), to_uint8(stereo_frame.right))
        ref = ref.astype(np.float32) / 16.0
        both = np.asarray(valid) & (ref > 0)
        assert both.mean() > 0.4
        agree = np.abs(np.asarray(disp)[both] - ref[both]) <= 1.0
        assert agree.mean() > 0.85, f"cv2 agreement {agree.mean()}"


class TestCostDtype:
    def test_bf16_storage_matches_f32(self, stereo_frame):
        """bf16 storage of the costs and of each direction's aggregation:
        with a penalty past bfloat16's exact integers (P2 = 300, values up
        to 332) the stored values round, and only rare WTA ties flip."""
        left = jnp.asarray(stereo_frame.left)
        right = jnp.asarray(stereo_frame.right)
        d32, v32 = sgm_disparity(left, right,
                                 _cfg(p2=300.0, cost_dtype="float32"))
        d16, v16 = sgm_disparity(left, right,
                                 _cfg(p2=300.0, cost_dtype="bfloat16"))
        both = np.asarray(v32) & np.asarray(v16)
        assert both.mean() > 0.5
        close = np.abs(np.asarray(d32)[both] - np.asarray(d16)[both]) <= 1.0
        assert close.mean() > 0.995, f"bf16 agreement {close.mean():.4f}"
        flipped = np.asarray(v32) != np.asarray(v16)
        assert flipped.mean() < 0.02, f"validity flips {flipped.mean():.4f}"
