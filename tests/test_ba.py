"""BA correctness (SURVEY.md §4.3): synthetic bundles with known optimum,
gradient cross-check via jax.grad, Schur-vs-direct equivalence, GN descent."""

import numpy as np

import jax
import jax.numpy as jnp

from online_3d_reconstruction.ba.problem import (
    BAProblem,
    residuals,
    total_cost,
)
from online_3d_reconstruction.ba.schur import (
    accumulate_normal_blocks,
    schur_solve,
    solve_ba,
)
from online_3d_reconstruction.config import BAConfig
from online_3d_reconstruction.ba.window import WindowBA
from online_3d_reconstruction.geometry import se3


from online_3d_reconstruction.ba.testing import make_synthetic_bundle


def _make_problem(rng, **kw):
    return make_synthetic_bundle(rng, **kw)


class TestGradients:
    def test_accumulated_gradient_matches_jax_grad(self):
        rng = np.random.default_rng(0)
        problem, _, _ = _make_problem(rng, w=3, l=8)

        def cost_fn(xi, dx):
            poses = jax.vmap(se3.retract)(problem.poses, xi)
            return total_cost(poses, problem.landmarks + dx, problem, 0.0)

        xi0 = jnp.zeros((3, 6))
        dx0 = jnp.zeros((8, 3))
        g_xi, g_dx = jax.grad(cost_fn, argnums=(0, 1))(xi0, dx0)

        _, _, _, g_p, g_x = accumulate_normal_blocks(
            problem.poses, problem.landmarks, problem, 0.0
        )
        np.testing.assert_allclose(np.asarray(g_p), np.asarray(g_xi),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(np.asarray(g_x), np.asarray(g_dx),
                                   rtol=1e-3, atol=1e-4)


class TestSchur:
    def test_schur_equals_direct_solve(self):
        rng = np.random.default_rng(1)
        problem, _, _ = _make_problem(rng, w=3, l=6)
        b, c, e, g_p, g_x = accumulate_normal_blocks(
            problem.poses, problem.landmarks, problem, 0.0
        )
        damping = 1e-4
        dp, dx = schur_solve(b, c, e, g_p, g_x, damping, anchor_first=True)

        # dense full-system reference in numpy (poses 1.. free, pose 0 fixed)
        w, l = 3, 6
        bb, cc, ee = np.asarray(b), np.asarray(c), np.asarray(e)
        h = np.zeros((6 * w + 3 * l, 6 * w + 3 * l))
        g = np.zeros(6 * w + 3 * l)
        for k in range(w):
            h[6 * k:6 * k + 6, 6 * k:6 * k + 6] = bb[k] + damping * np.eye(6)
            g[6 * k:6 * k + 6] = np.asarray(g_p)[k]
        for j in range(l):
            o = 6 * w + 3 * j
            h[o:o + 3, o:o + 3] = cc[j] + (damping + 1e-8) * np.eye(3)
            g[o:o + 3] = np.asarray(g_x)[j]
        for k in range(w):
            for j in range(l):
                o = 6 * w + 3 * j
                h[6 * k:6 * k + 6, o:o + 3] = ee[k, j]
                h[o:o + 3, 6 * k:6 * k + 6] = ee[k, j].T
        free = np.arange(6, h.shape[0])  # anchor pose 0
        sol = np.linalg.solve(h[np.ix_(free, free)], -g[free])
        dp_ref = sol[: 6 * (w - 1)].reshape(w - 1, 6)
        dx_ref = sol[6 * (w - 1):].reshape(l, 3)

        np.testing.assert_allclose(np.asarray(dp)[0], 0.0, atol=1e-7)
        np.testing.assert_allclose(np.asarray(dp)[1:], dp_ref, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(np.asarray(dx), dx_ref, rtol=1e-3, atol=1e-4)


class TestSolve:
    def test_recovers_ground_truth_noiseless(self):
        rng = np.random.default_rng(2)
        problem, gt_poses, gt_lms = _make_problem(rng, w=4, l=32)
        poses, lms, trace = solve_ba(problem, iters=8, damping=1e-6,
                                     huber_delta=0.0)
        t = np.asarray(trace)
        assert t[-1] < 1e-6 * max(t[0], 1.0), f"cost trace {t}"
        for k in range(4):
            t_err, r_err = se3.geodesic_distance(
                jnp.asarray(gt_poses[k]), poses[k]
            )
            assert float(t_err) < 1e-3
            assert float(r_err) < 1e-3

    def test_cost_monotone_under_noise(self):
        rng = np.random.default_rng(3)
        problem, _, _ = _make_problem(rng, w=5, l=48, obs_noise=0.05)
        _, _, trace = solve_ba(problem, iters=6, damping=1e-4, huber_delta=0.5)
        t = np.asarray(trace)
        assert np.all(np.diff(t) <= 1e-5), f"cost increased: {t}"
        assert t[-1] < t[0]

    def test_improves_noisy_poses_vs_ground_truth(self):
        rng = np.random.default_rng(4)
        problem, gt_poses, _ = _make_problem(rng, w=5, l=64, pose_noise=0.1,
                                             obs_noise=0.02)
        before = [
            float(se3.geodesic_distance(jnp.asarray(gt_poses[k]), problem.poses[k])[0])
            for k in range(1, 5)
        ]
        poses, _, _ = solve_ba(problem, iters=6, damping=1e-4, huber_delta=0.5)
        after = [
            float(se3.geodesic_distance(jnp.asarray(gt_poses[k]), poses[k])[0])
            for k in range(1, 5)
        ]
        assert np.mean(after) < 0.5 * np.mean(before), (before, after)


class TestWindowBA:
    def test_track_linking_and_solve(self):
        """Three keyframes observing the same landmark set via chained matches."""
        rng = np.random.default_rng(5)
        k_kp = 64
        gt_lms = np.stack(
            [rng.uniform(-3, 7, k_kp), rng.uniform(-3, 3, k_kp), np.zeros(k_kp)],
            axis=1,
        ).astype(np.float32)
        cfg = BAConfig(window=4, max_landmarks=128, max_obs=512, gn_iters=6)
        wba = WindowBA(cfg)
        gt_poses, noisy_poses = [], []
        for k in range(3):
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = np.diag([1.0, -1.0, -1.0])
            pose[:3, 3] = [2.0 * k, 0.0, 8.0]
            gt_poses.append(pose)
            noisy = pose.copy()
            if k > 0:
                noisy[:3, 3] += rng.normal(0, 0.2, 3).astype(np.float32)
            noisy_poses.append(noisy)
            inv = np.linalg.inv(pose)
            pts = gt_lms @ inv[:3, :3].T + inv[:3, 3]
            # identity matches: keypoint i in every frame sees landmark i
            match_idx = np.arange(k_kp)
            wba.add_keyframe(
                index=k, points3d=pts, valid3d=np.ones(k_kp, bool),
                pose=noisy, match_index=match_idx if k > 0 else None,
                match_valid=np.ones(k_kp, bool) if k > 0 else None,
            )
        refined = wba.solve_window()
        assert refined is not None
        assert wba.last_stats["landmarks"] == k_kp
        for k in range(1, 3):
            before = np.linalg.norm(noisy_poses[k][:3, 3] - gt_poses[k][:3, 3])
            after = np.linalg.norm(refined[k][:3, 3] - gt_poses[k][:3, 3])
            assert after < 0.2 * before, (before, after)

    def test_overflow_accounted(self):
        cfg = BAConfig(window=2, max_landmarks=4, max_obs=6, gn_iters=2)
        wba = WindowBA(cfg)
        rng = np.random.default_rng(6)
        for k in range(2):
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = [k, 0, 5]
            pts = rng.normal(0, 2, (16, 3)).astype(np.float32)
            wba.add_keyframe(
                index=k, points3d=pts, valid3d=np.ones(16, bool), pose=pose,
                match_index=np.arange(16) if k else None,
                match_valid=np.ones(16, bool) if k else None,
            )
        wba.solve_window()
        assert wba.last_stats["dropped_landmarks"] > 0
        assert wba.last_stats["observations"] == 6


class TestPosePriors:
    def _with_priors(self, rng, rot_offset=0.0):
        problem, gt_poses, _ = _make_problem(rng, w=3, l=8)
        priors = np.asarray(gt_poses, np.float32).copy()
        if rot_offset:
            for k in range(1, 3):
                xi = np.zeros(6, np.float32)
                xi[3:] = rng.normal(0, rot_offset, 3)
                priors[k] = np.asarray(se3.retract(jnp.asarray(priors[k]),
                                                   jnp.asarray(xi)))
        return problem._replace(
            priors=jnp.asarray(priors),
            prior_valid=jnp.ones(3, bool),
        )

    def test_position_prior_gradient_matches_jax_grad(self):
        from online_3d_reconstruction.ba.problem import prior_residuals
        rng = np.random.default_rng(21)
        problem = self._with_priors(rng)
        w_pos = 7.0

        def cost_fn(xi):
            poses = jax.vmap(se3.retract)(problem.poses, xi)
            r_pos, _ = prior_residuals(poses, problem)
            return (total_cost(poses, problem.landmarks, problem, 0.0)
                    + 0.5 * w_pos * jnp.sum(r_pos * r_pos))

        g_auto = jax.grad(cost_fn)(jnp.zeros((3, 6)))
        _, _, _, g_p, _ = accumulate_normal_blocks(
            problem.poses, problem.landmarks, problem, 0.0,
            prior_position_weight=w_pos,
        )
        np.testing.assert_allclose(np.asarray(g_p), np.asarray(g_auto),
                                   rtol=1e-4, atol=1e-5)

    def test_priors_only_solve_snaps_to_priors(self):
        """No visual observations: the solve must land on the priors."""
        rng = np.random.default_rng(22)
        problem = self._with_priors(rng)
        problem = problem._replace(obs_valid=jnp.zeros_like(problem.obs_valid))
        poses, _, _ = solve_ba(problem, iters=6, damping=1e-6,
                               huber_delta=0.0, anchor_first=False,
                               prior_position_weight=50.0,
                               prior_rotation_weight=50.0)
        np.testing.assert_allclose(np.asarray(poses),
                                   np.asarray(problem.priors),
                                   rtol=1e-3, atol=1e-3)

    def test_sharded_prior_solve_matches_single_device(self):
        import jax as _jax
        from jax.sharding import Mesh
        from online_3d_reconstruction.parallel.ba_sharded import solve_ba_sharded

        rng = np.random.default_rng(23)
        problem = self._with_priors(rng, rot_offset=0.01)
        kw = dict(iters=4, damping=1e-4, huber_delta=0.3, anchor_first=False,
                  prior_position_weight=20.0, prior_rotation_weight=100.0)
        single = solve_ba(problem, **kw)
        mesh = Mesh(np.array(_jax.devices()[:4]), ("obs",))
        sharded = solve_ba_sharded(problem, mesh, **kw)
        np.testing.assert_allclose(np.asarray(single[0]),
                                   np.asarray(sharded[0]), atol=1e-4)
        np.testing.assert_allclose(float(single[2][-1]),
                                   float(sharded[2][-1]), rtol=1e-5)


class TestSlotMajorEquivalence:
    """The analytic slot-major accumulation (ba/schur._accumulate_slot_major)
    must match the generic J-based path block for block — unweighted,
    diagonal-weighted, AND full-3x3-weighted. This gap let the r5 rewrite
    ship untested for the weighted case (it happened to be correct; the
    divergence it was suspected of was the frontend's raw-fallback links)."""

    def _problem(self, rng, w=4, l=32, k=16):
        from online_3d_reconstruction.ba.testing import make_synthetic_bundle

        problem, _, _ = make_synthetic_bundle(rng, w=w, l=l, obs_noise=0.05,
                                              n_cap=w * k, obs_per_kf=k)
        return problem, k

    def _assert_blocks_match(self, problem, k, **kw):
        from online_3d_reconstruction.ba.schur import accumulate_normal_blocks

        gen = accumulate_normal_blocks(problem.poses, problem.landmarks,
                                       problem, 0.5, **kw)
        slo = accumulate_normal_blocks(problem.poses, problem.landmarks,
                                       problem, 0.5, slot_major=k, **kw)
        for name, a, b in zip(("B", "C", "E", "g_p", "g_x"), gen, slo):
            scale = max(float(jnp.max(jnp.abs(a))), 1.0)
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=2e-6 * scale,
                err_msg=f"slot-major {name} diverges from the generic path")

    def test_unweighted(self):
        problem, k = self._problem(np.random.default_rng(0))
        self._assert_blocks_match(problem, k)

    def test_diagonal_weights(self):
        problem, k = self._problem(np.random.default_rng(1))
        w = jnp.abs(jnp.asarray(
            np.random.default_rng(2).normal(1.0, 0.3,
                                            problem.obs_point.shape)
            .astype(np.float32))) + 0.1
        self._assert_blocks_match(problem._replace(obs_weight=w), k)

    def test_full_3x3_information(self):
        from online_3d_reconstruction.ba.problem import (
            StereoNoiseModel,
            stereo_obs_information,
        )

        problem, k = self._problem(np.random.default_rng(3))
        nm = StereoNoiseModel(fx=300.0, fy=300.0, baseline=0.5,
                              sigma_px=0.5, sigma_disparity=1.0)
        w = stereo_obs_information(problem.obs_point, nm)
        self._assert_blocks_match(problem._replace(obs_weight=w), k)

    def test_with_priors(self):
        problem, k = self._problem(np.random.default_rng(4))
        pri = problem._replace(priors=problem.poses,
                               prior_valid=jnp.ones(problem.poses.shape[0],
                                                    bool))
        self._assert_blocks_match(pri, k, prior_position_weight=20.0,
                                  prior_rotation_weight=100.0)
