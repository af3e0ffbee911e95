"""On-device sliding-window BA: track building + solve as ONE dispatch.

The reference links feature tracks across its keyframe window on the host
(std::vector bookkeeping) before its sparse CPU solve (SURVEY.md §2.1
C10/C11). The first port of that (ba/window.py) kept the track table in
numpy, which costs a device_get of the keyframe features plus ~10 small
host<->device transfers per keyframe event, each a synchronising round
trip.

This module removes the host from the loop entirely. The keyframe window
lives on device as a fixed-shape ring (``WindowState``), and a keyframe event
is ONE jitted call that:

1. shifts the ring and appends the new keyframe (points, validity, the
   matcher's index/valid link to the previous keyframe, pose, prior);
2. builds landmark tracks from the match chains: each keypoint's *root* is
   found by a ``lax.scan`` over the window slots (root = chain start id),
   so a landmark is exactly a maximal match chain;
3. densifies landmark ids with the same sort + boundary-cumsum trick as the
   voxel filter (mapping/voxel.py), drops single-observation landmarks,
   caps at the static landmark capacity (overflow *counted*, never hidden);
4. initializes landmarks at the mean of their world-lifted observations;
5. runs the dense-block Schur Gauss-Newton (ba/schur.py) and writes the
   refined poses back into the ring.

Everything is static-shape; no value ever returns to the host unless the
caller explicitly pulls the stats it wants.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from online_3d_reconstruction.ba.problem import BAProblem
from online_3d_reconstruction.ba.schur import solve_ba
from online_3d_reconstruction.config import BAConfig
from online_3d_reconstruction.geometry import se3

_SENTINEL = jnp.int32(2**31 - 1)


class WindowState(NamedTuple):
    """Device-resident keyframe window (slot 0 oldest .. count-1 newest)."""

    points3d: jnp.ndarray   # (W, K, 3) camera-frame keypoint lifts
    valid3d: jnp.ndarray    # (W, K) bool
    match_idx: jnp.ndarray  # (W, K) int32 — link into slot k-1's keypoints
    match_ok: jnp.ndarray   # (W, K) bool — link valid (slot 0: all False)
    poses: jnp.ndarray      # (W, 4, 4) world-from-camera (identity when empty)
    priors: jnp.ndarray     # (W, 4, 4) flight-log priors (bookkeeping only)
    count: jnp.ndarray      # () int32 — live slots


def create_window(window: int, max_keypoints: int) -> WindowState:
    w, k = window, max_keypoints
    # poses/priors must be distinct buffers: keyframe_step donates the state
    # and XLA rejects donating one buffer through two leaves
    eye = lambda: jnp.tile(jnp.eye(4, dtype=jnp.float32), (w, 1, 1))
    return WindowState(
        points3d=jnp.zeros((w, k, 3), jnp.float32),
        valid3d=jnp.zeros((w, k), bool),
        match_idx=jnp.zeros((w, k), jnp.int32),
        match_ok=jnp.zeros((w, k), bool),
        poses=eye(),
        priors=eye(),
        count=jnp.zeros((), jnp.int32),
    )


def _append(state: WindowState, points3d, valid3d, match_idx, match_ok,
            pose, prior) -> WindowState:
    """Shift-if-full + write the new keyframe at slot min(count, W-1)."""
    w = state.poses.shape[0]

    def shift(s: WindowState) -> WindowState:
        roll = lambda a: jnp.roll(a, -1, axis=0)
        # the new slot 0's link pointed at the dropped keyframe: sever it
        return WindowState(
            points3d=roll(s.points3d),
            valid3d=roll(s.valid3d),
            match_idx=roll(s.match_idx),
            match_ok=roll(s.match_ok).at[0].set(False),
            poses=roll(s.poses),
            priors=roll(s.priors),
            count=jnp.int32(w - 1),
        )

    state = jax.lax.cond(state.count >= w, shift, lambda s: s, state)
    at = state.count  # < W now
    # a track link only counts when both endpoints have usable 3D lifts
    # (matches ba/window.py's host gating); slot 0 never links backward
    prev_valid = state.valid3d[jnp.maximum(at - 1, 0)]
    link_ok = match_ok & valid3d & prev_valid[match_idx] & (at > 0)
    return WindowState(
        points3d=state.points3d.at[at].set(points3d),
        valid3d=state.valid3d.at[at].set(valid3d),
        match_idx=state.match_idx.at[at].set(match_idx),
        match_ok=state.match_ok.at[at].set(link_ok),
        poses=state.poses.at[at].set(pose),
        priors=state.priors.at[at].set(prior),
        count=at + 1,
    )


def _chain_roots(match_idx: jnp.ndarray, match_ok: jnp.ndarray) -> jnp.ndarray:
    """(W, K) int32 — per keypoint, the flat id (slot*K + kp) of its chain
    start. A keypoint with no valid link to the previous slot starts a chain."""
    w, k = match_idx.shape
    own = (jnp.arange(w, dtype=jnp.int32)[:, None] * k
           + jnp.arange(k, dtype=jnp.int32)[None, :])

    def step(prev_root, inp):
        idx, ok, own_k = inp
        root = jnp.where(ok, prev_root[idx], own_k)
        return root, root

    _, roots = jax.lax.scan(step, own[0], (match_idx, match_ok, own))
    return roots


def build_problem(state: WindowState, max_landmarks: int,
                  noise_model=None) -> Tuple[BAProblem, dict]:
    """Pack the window into a fixed-capacity BAProblem (pure device code).

    Landmark = maximal match chain with >= 2 valid 3D observations inside the
    live window. ``noise_model`` (a ba.problem.StereoNoiseModel) enables the
    full 3x3 per-observation information matrices
    (ba.problem.stereo_obs_information); the pipeline builds it from the rig
    geometry + BAConfig sigmas. Returns (problem, stats) where stats holds
    device scalars {landmarks, observations, dropped_landmarks}.
    """
    w, k = state.valid3d.shape
    n = w * k
    l_cap = max_landmarks

    slot = jnp.arange(w, dtype=jnp.int32)[:, None]
    live = slot < state.count                           # (W, 1)
    obs_ok = (state.valid3d & live).reshape(n)
    roots = _chain_roots(state.match_idx, state.match_ok).reshape(n)

    # Dense landmark ids WITHOUT scatters or segment_sums (chosen for the earlier accelerator target; not yet measured on the H100):
    # 1. one two-operand sort carries the original position alongside the key;
    keyed = jnp.where(obs_ok, roots, _SENTINEL)
    sorted_r, order = jax.lax.sort(
        (keyed, jnp.arange(n, dtype=jnp.int32)), num_keys=1)
    is_new = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_r[1:] != sorted_r[:-1]]
    )
    # 2. per-position run length via two segmented cumsums (no count table);
    def seg_csum(vals, flag, reverse):
        def combine(a, b):
            av, af = a
            bv, bf = b
            return jnp.where(bf, bv, av + bv), af | bf
        out, _ = jax.lax.associative_scan(combine, (vals, flag),
                                          reverse=reverse)
        return out

    ones = jnp.ones((n,), jnp.int32)
    end_flag = jnp.roll(is_new, -1)  # starts flip to run ends for the bwd scan
    run_len = (seg_csum(ones, is_new, False)
               + seg_csum(ones, end_flag, True) - 1)
    real = sorted_r != _SENTINEL
    keep_pos = (run_len >= 2) & real                     # co-observed only
    # 3. dense ids = prefix count of kept segment starts (constant in a run);
    new_id = jnp.cumsum((is_new & keep_pos).astype(jnp.int32)) - 1
    lm_sorted = jnp.where(keep_pos, new_id, -1)
    # 4. a second sort by original position plays the inverse permutation.
    _, lm_flat = jax.lax.sort((order, lm_sorted), num_keys=1)

    n_lm = jnp.sum((is_new & keep_pos).astype(jnp.int32))
    dropped_lm = jnp.maximum(n_lm - l_cap, 0)
    obs_valid = obs_ok & (lm_flat >= 0) & (lm_flat < l_cap)
    obs_lm = jnp.clip(lm_flat, 0, l_cap - 1)
    obs_kf = jnp.repeat(jnp.arange(w, dtype=jnp.int32), k)
    obs_pt = state.points3d.reshape(n, 3)

    # landmark init: mean world lift under current poses. The per-slot pose
    # applies to a contiguous (W, K) block — an einsum, not a gather; the
    # per-landmark mean is a one-hot (L_cap, N) matmul, not a segment_sum.
    # HIGHEST: bf16 would quantize 30 m world coords to ~12 cm, poisoning
    # the landmark initialization
    world = (jnp.einsum("wij,wkj->wki", state.poses[:, :3, :3], state.points3d,
                        precision=jax.lax.Precision.HIGHEST)
             + state.poses[:, None, :3, 3]).reshape(n, 3)
    onehot = ((lm_flat[:, None] == jnp.arange(l_cap, dtype=jnp.int32)[None, :])
              & obs_valid[:, None]).astype(jnp.float32)   # (N, L)
    # HIGHEST here too: this matmul accumulates ~30-60 m world coordinates,
    # which a reduced-precision default (bf16, or TF32 on the GPU) quantizes
    # — the same class of silent on-accelerator-only bug as the r4
    # normal-equation einsums and the r5 rigid_transform products
    lm_sum = jnp.matmul(onehot.T, world,
                        precision=jax.lax.Precision.HIGHEST)  # (L, 3)
    lm_cnt = jnp.sum(onehot, axis=0)
    lm_valid = lm_cnt > 0
    lm_init = lm_sum / jnp.maximum(lm_cnt, 1.0)[:, None]

    obs_weight = None
    if noise_model is not None:
        from online_3d_reconstruction.ba.problem import stereo_obs_information

        obs_weight = stereo_obs_information(obs_pt, noise_model)

    problem = BAProblem(
        poses=state.poses,
        landmarks=lm_init,
        lm_valid=lm_valid,
        obs_kf=obs_kf,
        obs_lm=obs_lm,
        obs_point=obs_pt,
        obs_valid=obs_valid,
        priors=state.priors,
        prior_valid=live[:, 0],
        obs_weight=obs_weight,
    )
    stats = {
        "landmarks": jnp.minimum(n_lm, l_cap),
        "observations": jnp.sum(obs_valid.astype(jnp.int32)),
        "dropped_landmarks": dropped_lm,
    }
    return problem, stats


def keyframe_core(
    state: WindowState,
    points3d: jnp.ndarray,
    valid3d: jnp.ndarray,
    match_idx: jnp.ndarray,
    match_ok: jnp.ndarray,
    pose: jnp.ndarray,
    prior: jnp.ndarray,
    cfg: BAConfig,
    mesh=None,
    noise_model=None,
) -> Tuple[WindowState, jnp.ndarray, dict]:
    """Append a keyframe and refine the window (traceable body; see
    ``keyframe_step`` for the standalone jitted form — the online loop
    inlines this into its single per-frame dispatch instead).

    ``mesh`` routes the solve through the observation-sharded distributed
    Schur solver (parallel/ba_sharded.py, P2) — the track build and problem
    packing above it are pure device code either way, so the distributed
    keyframe event stays O(1) dispatches with zero host round trips.

    Returns (new state, refined poses (W, 4, 4) aligned with window slots,
    stats dict of device scalars). When fewer than 2 keyframes are live the
    solve degenerates gracefully (no co-observed landmarks -> damping-only
    steps leave poses unchanged).
    """
    state = _append(state, points3d, valid3d, match_idx, match_ok, pose, prior)
    problem, stats = build_problem(state, cfg.max_landmarks, noise_model)
    # absolute priors on position AND rotation fix the gauge completely (and
    # bound drift); the hard first-pose anchor would pin the window to its
    # own dead-reckoned drift, so it only applies when priors are off
    full_priors = cfg.prior_position_weight > 0 and cfg.prior_rotation_weight > 0
    solve_kw = dict(
        iters=cfg.gn_iters,
        damping=cfg.damping,
        huber_delta=cfg.huber_delta,
        anchor_first=cfg.anchor_first and not full_priors,
        prior_position_weight=cfg.prior_position_weight,
        prior_rotation_weight=cfg.prior_rotation_weight,
    )
    if mesh is None:
        # the window's obs list is slot-major by construction (K obs
        # per slot) — selects the O(N*L) large-window accumulation
        poses_ref, _, cost_trace = solve_ba(
            problem, slot_major=state.valid3d.shape[1], **solve_kw)
    else:
        from online_3d_reconstruction.parallel.ba_sharded import solve_ba_sharded
        poses_ref, _, cost_trace = solve_ba_sharded(problem, mesh, **solve_kw)
    # only live slots move; empty slots keep identity for the next append
    live = (jnp.arange(state.poses.shape[0]) < state.count)[:, None, None]
    poses_new = jnp.where(live, poses_ref, state.poses)
    state = state._replace(poses=poses_new)
    stats = dict(stats)
    stats["cost_initial"] = cost_trace[0]
    stats["cost_final"] = cost_trace[-1]
    return state, poses_new, stats


# standalone jitted form: one dispatch per keyframe event, state donated
keyframe_step = partial(jax.jit,
                        static_argnames=("cfg", "mesh", "noise_model"),
                        donate_argnums=(0,))(keyframe_core)
