"""Umeyama rigid fit + RANSAC: exact recovery, outlier robustness, gating."""

import numpy as np

import jax
import jax.numpy as jnp

from online_3d_reconstruction.geometry import se3
from online_3d_reconstruction.odometry.rigid import ransac_rigid, rigid_transform


def _random_pose(rng, t_scale=2.0, r_scale=0.5):
    xi = np.concatenate([rng.normal(0, t_scale, 3), rng.normal(0, r_scale, 3)])
    return np.asarray(se3.exp(jnp.asarray(xi, dtype=jnp.float32)))


class TestUmeyama:
    def test_exact_recovery(self):
        rng = np.random.default_rng(0)
        t_gt = _random_pose(rng)
        src = rng.normal(0, 5, (40, 3)).astype(np.float32)
        dst = src @ t_gt[:3, :3].T + t_gt[:3, 3]
        t_est = np.asarray(rigid_transform(jnp.asarray(src), jnp.asarray(dst),
                                           jnp.ones(40)))
        np.testing.assert_allclose(t_est, t_gt, atol=1e-4)

    def test_weighted_ignores_zero_weight_outliers(self):
        rng = np.random.default_rng(1)
        t_gt = _random_pose(rng)
        src = rng.normal(0, 5, (40, 3)).astype(np.float32)
        dst = src @ t_gt[:3, :3].T + t_gt[:3, 3]
        dst[:10] += 100.0  # corrupted, but weighted out
        w = np.ones(40, np.float32)
        w[:10] = 0.0
        t_est = np.asarray(rigid_transform(jnp.asarray(src), jnp.asarray(dst),
                                           jnp.asarray(w)))
        np.testing.assert_allclose(t_est, t_gt, atol=1e-4)

    def test_reflection_guard(self):
        """Near-planar points must still produce det(R) = +1."""
        rng = np.random.default_rng(2)
        src = rng.normal(0, 5, (20, 3)).astype(np.float32)
        src[:, 2] *= 1e-6
        t_gt = _random_pose(rng)
        dst = src @ t_gt[:3, :3].T + t_gt[:3, 3]
        t_est = np.asarray(rigid_transform(jnp.asarray(src), jnp.asarray(dst),
                                           jnp.ones(20)))
        assert np.linalg.det(t_est[:3, :3]) > 0.99


class TestRansac:
    def test_recovers_pose_with_outliers(self):
        rng = np.random.default_rng(3)
        t_gt = _random_pose(rng)
        n = 128
        src = rng.normal(0, 8, (n, 3)).astype(np.float32)
        dst = (src @ t_gt[:3, :3].T + t_gt[:3, 3]).astype(np.float32)
        dst += rng.normal(0, 0.01, dst.shape).astype(np.float32)
        out_idx = rng.choice(n, 40, replace=False)
        dst[out_idx] = rng.normal(0, 8, (40, 3))  # 30% outliers
        t_est, mask, count, ok = ransac_rigid(
            jnp.asarray(src), jnp.asarray(dst), jnp.ones(n, bool),
            jax.random.PRNGKey(0), iters=128, threshold=0.1,
        )
        assert bool(ok)
        assert int(count) > 70
        t_err, r_err = se3.geodesic_distance(jnp.asarray(t_gt), t_est)
        assert float(t_err) < 0.05
        assert float(r_err) < 0.01
        inl = np.asarray(mask)
        assert not inl[out_idx].any() or inl[out_idx].mean() < 0.1

    def test_gate_fails_without_inliers(self):
        rng = np.random.default_rng(4)
        src = rng.normal(0, 5, (64, 3)).astype(np.float32)
        dst = rng.normal(0, 5, (64, 3)).astype(np.float32)  # no rigid relation
        t_est, _, count, ok = ransac_rigid(
            jnp.asarray(src), jnp.asarray(dst), jnp.ones(64, bool),
            jax.random.PRNGKey(1), iters=64, threshold=0.05, min_inliers=12,
        )
        assert not bool(ok)
        np.testing.assert_array_equal(np.asarray(t_est), np.eye(4))

    def test_gate_fails_with_too_few_valid(self):
        rng = np.random.default_rng(5)
        t_gt = _random_pose(rng)
        src = rng.normal(0, 5, (64, 3)).astype(np.float32)
        dst = src @ t_gt[:3, :3].T + t_gt[:3, 3]
        valid = np.zeros(64, bool)
        valid[:5] = True  # < min_inliers possible
        _, _, count, ok = ransac_rigid(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
            jax.random.PRNGKey(2), iters=64, threshold=0.1, min_inliers=12,
        )
        assert not bool(ok)
