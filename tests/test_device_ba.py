"""On-device window BA (ba/device_tracks.py): track building equivalence vs
the host WindowBA table, rolling-window behavior, and solve quality."""

import numpy as np

import jax.numpy as jnp

from online_3d_reconstruction.ba.device_tracks import (
    WindowState,
    build_problem,
    create_window,
    keyframe_step,
    _append,
    _chain_roots,
)
from online_3d_reconstruction.ba.window import WindowBA
from online_3d_reconstruction.config import BAConfig


def _chain_scenario(rng, n_kf=3, k_kp=64, drop_prob=0.0, pose_noise=0.2):
    """Keyframes over a fixed landmark field with (optionally broken) identity
    match chains; returns per-keyframe dicts + gt/noisy poses."""
    gt_lms = np.stack(
        [rng.uniform(-3, 7, k_kp), rng.uniform(-3, 3, k_kp), np.zeros(k_kp)],
        axis=1,
    ).astype(np.float32)
    frames, gt_poses, noisy_poses = [], [], []
    for k in range(n_kf):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.diag([1.0, -1.0, -1.0])
        pose[:3, 3] = [2.0 * k, 0.0, 8.0]
        gt_poses.append(pose)
        noisy = pose.copy()
        if k > 0:
            noisy[:3, 3] += rng.normal(0, pose_noise, 3).astype(np.float32)
        noisy_poses.append(noisy)
        inv = np.linalg.inv(pose)
        pts = gt_lms @ inv[:3, :3].T + inv[:3, 3]
        ok = np.ones(k_kp, bool)
        if drop_prob > 0 and k > 0:
            ok = rng.random(k_kp) > drop_prob
        frames.append(
            dict(points3d=pts.astype(np.float32), valid3d=np.ones(k_kp, bool),
                 match_idx=np.arange(k_kp, dtype=np.int32), match_ok=ok,
                 pose=noisy)
        )
    return frames, np.stack(gt_poses), np.stack(noisy_poses)


def _insert_all(cfg, frames):
    state = create_window(cfg.window, len(frames[0]["valid3d"]))
    for k, f in enumerate(frames):
        state = _append(
            state,
            jnp.asarray(f["points3d"]), jnp.asarray(f["valid3d"]),
            jnp.asarray(f["match_idx"]),
            jnp.asarray(f["match_ok"] if k > 0 else np.zeros_like(f["match_ok"])),
            jnp.asarray(f["pose"]), jnp.asarray(f["pose"]),
        )
    return state


class TestChainRoots:
    def test_unbroken_chain_single_root(self):
        w, k = 4, 8
        idx = jnp.tile(jnp.arange(k, dtype=jnp.int32), (w, 1))
        ok = jnp.ones((w, k), bool).at[0].set(False)
        roots = np.asarray(_chain_roots(idx, ok))
        # every slot's keypoint i chains back to slot-0 keypoint i
        assert (roots == np.arange(k)[None, :]).all()

    def test_broken_link_starts_new_chain(self):
        w, k = 3, 4
        idx = jnp.tile(jnp.arange(k, dtype=jnp.int32), (w, 1))
        ok = jnp.ones((w, k), bool).at[0].set(False).at[1, 2].set(False)
        roots = np.asarray(_chain_roots(idx, ok))
        assert roots[1, 2] == 1 * k + 2          # new chain at slot 1
        assert roots[2, 2] == 1 * k + 2          # slot 2 follows the new chain
        assert roots[2, 0] == 0                  # unbroken chain keeps root 0

    def test_permuted_matches_follow_indices(self):
        k = 4
        idx = jnp.asarray([[0, 1, 2, 3], [3, 2, 1, 0]], dtype=jnp.int32)
        ok = jnp.asarray([[False] * 4, [True] * 4])
        roots = np.asarray(_chain_roots(idx, ok))
        assert (roots[1] == np.asarray([3, 2, 1, 0])).all()


class TestBuildProblem:
    def test_matches_host_window_ba_counts(self):
        rng = np.random.default_rng(5)
        frames, _, _ = _chain_scenario(rng, n_kf=3, k_kp=64, drop_prob=0.3)
        cfg = BAConfig(window=4, max_landmarks=128, max_obs=512, gn_iters=6)

        wba = WindowBA(cfg)
        for k, f in enumerate(frames):
            wba.add_keyframe(
                index=k, points3d=f["points3d"], valid3d=f["valid3d"],
                pose=f["pose"],
                match_index=f["match_idx"] if k > 0 else None,
                match_valid=f["match_ok"] if k > 0 else None,
            )
        refined_host = wba.solve_window()

        state = _insert_all(cfg, frames)
        problem, stats = build_problem(state, cfg.max_landmarks)
        assert int(stats["landmarks"]) == wba.last_stats["landmarks"]
        assert int(stats["observations"]) == wba.last_stats["observations"]
        assert int(stats["dropped_landmarks"]) == wba.last_stats["dropped_landmarks"]

        # solving the device-packed problem lands on the same poses
        from online_3d_reconstruction.ba.schur import solve_ba

        poses_dev, _, _ = solve_ba(problem, iters=cfg.gn_iters,
                                   damping=cfg.damping,
                                   huber_delta=cfg.huber_delta)
        for k in range(3):
            np.testing.assert_allclose(
                np.asarray(poses_dev)[k], refined_host[k], atol=1e-3
            )

    def test_single_keyframe_no_landmarks(self):
        rng = np.random.default_rng(1)
        frames, _, _ = _chain_scenario(rng, n_kf=1, k_kp=16)
        cfg = BAConfig(window=4, max_landmarks=32, max_obs=64)
        state = _insert_all(cfg, frames)
        _, stats = build_problem(state, cfg.max_landmarks)
        assert int(stats["landmarks"]) == 0
        assert int(stats["observations"]) == 0

    def test_landmark_overflow_counted(self):
        rng = np.random.default_rng(2)
        frames, _, _ = _chain_scenario(rng, n_kf=2, k_kp=16)
        cfg = BAConfig(window=2, max_landmarks=4, max_obs=64)
        state = _insert_all(cfg, frames)
        _, stats = build_problem(state, cfg.max_landmarks)
        assert int(stats["dropped_landmarks"]) == 16 - 4
        assert int(stats["landmarks"]) == 4


class TestKeyframeStep:
    def test_refines_toward_ground_truth(self):
        rng = np.random.default_rng(7)
        frames, gt_poses, noisy_poses = _chain_scenario(rng, n_kf=3, k_kp=64)
        cfg = BAConfig(window=4, max_landmarks=128, max_obs=512, gn_iters=6,
                       prior_position_weight=0.0, prior_rotation_weight=0.0)
        state = create_window(cfg.window, 64)
        for k, f in enumerate(frames):
            state, refined, stats = keyframe_step(
                state,
                jnp.asarray(f["points3d"]), jnp.asarray(f["valid3d"]),
                jnp.asarray(f["match_idx"]), jnp.asarray(f["match_ok"]),
                jnp.asarray(f["pose"]), jnp.asarray(f["pose"]), cfg,
            )
        refined = np.asarray(refined)
        for k in range(1, 3):
            before = np.linalg.norm(noisy_poses[k][:3, 3] - gt_poses[k][:3, 3])
            after = np.linalg.norm(refined[k][:3, 3] - gt_poses[k][:3, 3])
            assert after < 0.2 * before, (k, before, after)

    def test_rolling_window_drops_oldest(self):
        rng = np.random.default_rng(9)
        n_kf, w = 6, 3
        frames, _, _ = _chain_scenario(rng, n_kf=n_kf, k_kp=16, pose_noise=0.0)
        cfg = BAConfig(window=w, max_landmarks=64, max_obs=256, gn_iters=1,
                       prior_position_weight=0.0, prior_rotation_weight=0.0)
        state = create_window(w, 16)
        for k, f in enumerate(frames):
            state, refined, stats = keyframe_step(
                state,
                jnp.asarray(f["points3d"]), jnp.asarray(f["valid3d"]),
                jnp.asarray(f["match_idx"]), jnp.asarray(f["match_ok"]),
                jnp.asarray(f["pose"]), jnp.asarray(f["pose"]), cfg,
            )
        assert int(state.count) == w
        # newest slot holds the last keyframe's pose (gt chain: x = 2k)
        assert abs(float(state.poses[w - 1, 0, 3]) - 2.0 * (n_kf - 1)) < 0.1
        # chains survive the shift: landmarks still co-observed across window
        assert int(stats["landmarks"]) == 16

    def test_first_keyframe_is_noop_solve(self):
        rng = np.random.default_rng(3)
        frames, _, _ = _chain_scenario(rng, n_kf=1, k_kp=16)
        cfg = BAConfig(window=4, max_landmarks=32, max_obs=64, gn_iters=3,
                       prior_position_weight=0.0, prior_rotation_weight=0.0)
        state = create_window(cfg.window, 16)
        f = frames[0]
        state, refined, stats = keyframe_step(
            state,
            jnp.asarray(f["points3d"]), jnp.asarray(f["valid3d"]),
            jnp.asarray(f["match_idx"]), jnp.asarray(f["match_ok"]),
            jnp.asarray(f["pose"]), jnp.asarray(f["pose"]), cfg,
        )
        np.testing.assert_allclose(np.asarray(refined)[0], f["pose"], atol=1e-5)
        assert int(state.count) == 1


class TestPoseePriors:
    def test_priors_bound_dead_reckoning_drift(self):
        """Drifted window poses + GT-quality priors: the prior terms pull the
        absolute trajectory back while visual links keep relative structure."""
        rng = np.random.default_rng(11)
        n_kf = 4
        frames, gt_poses, _ = _chain_scenario(rng, n_kf=n_kf, k_kp=64,
                                              pose_noise=0.0)
        # simulate dead-reckoning drift: growing common-mode offset
        drift = np.array([0.3, -0.2, 0.15], np.float32)
        cfg = BAConfig(window=4, max_landmarks=128, max_obs=512, gn_iters=8,
                       prior_position_weight=40.0, prior_rotation_weight=2500.0)
        state = create_window(cfg.window, 64)
        for k, f in enumerate(frames):
            drifted = f["pose"].copy()
            drifted[:3, 3] += drift * k
            state, refined, stats = keyframe_step(
                state,
                jnp.asarray(f["points3d"]), jnp.asarray(f["valid3d"]),
                jnp.asarray(f["match_idx"]), jnp.asarray(f["match_ok"]),
                jnp.asarray(drifted), jnp.asarray(gt_poses[k]), cfg,
            )
        refined = np.asarray(refined)
        for k in range(n_kf):
            err = np.linalg.norm(refined[k][:3, 3] - gt_poses[k][:3, 3])
            assert err < 0.12, (k, err)

    def test_zero_weights_ignore_priors(self):
        """weights=0 must reproduce the anchored pure-visual solve exactly."""
        rng = np.random.default_rng(12)
        frames, _, _ = _chain_scenario(rng, n_kf=3, k_kp=32)
        cfg0 = BAConfig(window=4, max_landmarks=64, max_obs=256, gn_iters=4,
                        prior_position_weight=0.0, prior_rotation_weight=0.0)
        state = create_window(cfg0.window, 32)
        outs = []
        for variant_prior in (True, False):
            st = create_window(cfg0.window, 32)
            for k, f in enumerate(frames):
                prior = f["pose"] if variant_prior else np.eye(4, dtype=np.float32)
                st, refined, _ = keyframe_step(
                    st,
                    jnp.asarray(f["points3d"]), jnp.asarray(f["valid3d"]),
                    jnp.asarray(f["match_idx"]), jnp.asarray(f["match_ok"]),
                    jnp.asarray(f["pose"]), jnp.asarray(prior), cfg0,
                )
            outs.append(np.asarray(refined))
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)
