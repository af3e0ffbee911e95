"""Distributed bundle adjustment: observation-sharded Schur assembly (P2).

North star: "distributed bundle adjustment via Schur-complement reduction
over psum/all-gather collectives". The normal-equation accumulations in
ba/schur.py are plain sums over the observation list, so the multi-device
form is exact and simple:

- observations are sharded along the mesh axis (``P('d')``);
- each device accumulates (B, C, E, g_p, g_x) over its shard;
- one ``psum`` reduces the blocks (B: W·36, C: L·9, E: W·L·18 floats —
  kilobytes over NVLink, not the raw observations);
- the tiny reduced camera system is solved replicated on every device
  (identical result, no broadcast needed).

Bit-equivalence with the single-device solver is asserted by
tests/test_parallel.py on a CPU-simulated 8-device mesh (SURVEY.md §4.4).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from online_3d_reconstruction.ba.problem import (
    BAProblem,
    prior_jacobians,
    prior_residuals,
    total_cost,
)
from online_3d_reconstruction.ba.schur import (
    accumulate_normal_blocks,
    schur_solve,
)
from online_3d_reconstruction.geometry import se3
from online_3d_reconstruction.parallel.mesh import pad_to_multiple


def _pad_observations(problem: BAProblem, n_devices: int) -> BAProblem:
    n = problem.obs_kf.shape[0]
    # the shard_map pytree is static: materialize unit weights when absent
    if problem.obs_weight is None:
        problem = problem._replace(
            obs_weight=jnp.ones((n, 3), jnp.float32)
        )
    target = pad_to_multiple(n, n_devices)
    if target == n:
        return problem
    pad = target - n
    # padded slots are obs_valid=False (residual/Jacobian rows zeroed), so
    # the pad value of the weight never matters — 1.0 keeps diag semantics
    w_pad = ((0, pad),) + ((0, 0),) * (problem.obs_weight.ndim - 1)
    return problem._replace(
        obs_kf=jnp.pad(problem.obs_kf, (0, pad)),
        obs_lm=jnp.pad(problem.obs_lm, (0, pad)),
        obs_point=jnp.pad(problem.obs_point, ((0, pad), (0, 0))),
        obs_valid=jnp.pad(problem.obs_valid, (0, pad)),
        obs_weight=jnp.pad(problem.obs_weight, w_pad, constant_values=1.0),
    )


def solve_ba_slot_sharded(
    problem: BAProblem,
    mesh: Mesh,
    slot_major: int,
    iters: int = 5,
    damping: float = 1e-4,
    huber_delta: float = 0.5,
    anchor_first: bool = True,
    prior_position_weight: float = 0.0,
    prior_rotation_weight: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """KEYFRAME-sharded distributed Schur solve for slot-major problems.

    The observation-sharded form (``solve_ba_sharded``) splits the flat obs
    list, which destroys the slot-major layout and forces the generic
    O(N*W*L) accumulation — prohibitive at W >= 64 (SURVEY.md:424). Here
    each device takes a contiguous block of W/n pose SLOTS (with their
    ``slot_major`` observations each), runs the cheap slot-major
    accumulation locally, then:

    - C, g_x (landmark blocks) are summed with one ``psum``;
    - B, g_p, E (per-pose blocks) are concatenated with one ``all_gather``
      along the slot axis (each device owned disjoint slots);
    - the reduced 6Wx6W camera system is solved replicated.

    Per-device accumulation work is O((N/n) * L); wire bytes per iteration
    are L*9 + L*3 (psum) + (W/n)*(36 + 6 + L*18) * n (gather) floats.
    Requires W % n_devices == 0 and N == W * slot_major.
    """
    w_count = problem.poses.shape[0]
    n_obs = problem.obs_kf.shape[0]
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    if w_count % n_dev or n_obs != w_count * slot_major:
        raise ValueError(
            f"slot-sharded BA needs W ({w_count}) % n_dev ({n_dev}) == 0 and "
            f"N ({n_obs}) == W * slot_major ({slot_major})")
    w_local = w_count // n_dev
    use_priors = problem.priors is not None and (
        prior_position_weight > 0 or prior_rotation_weight > 0
    )

    def _accumulate(poses, landmarks, lm_valid, obs_lm, obs_pt, obs_ok,
                    obs_w):
        # local problem: this device's w_local slots, re-indexed 0..w_local-1
        my = jax.lax.axis_index(axis)
        poses_local = jax.lax.dynamic_slice_in_dim(poses, my * w_local,
                                                   w_local, axis=0)
        local = BAProblem(
            poses=poses_local, landmarks=landmarks, lm_valid=lm_valid,
            obs_kf=jnp.repeat(jnp.arange(w_local, dtype=jnp.int32),
                              slot_major),
            obs_lm=obs_lm, obs_point=obs_pt, obs_valid=obs_ok,
            obs_weight=obs_w,
        )
        b, c, e, g_p, g_x = accumulate_normal_blocks(
            poses_local, landmarks, local, huber_delta,
            slot_major=slot_major)
        c = jax.lax.psum(c, axis)
        g_x = jax.lax.psum(g_x, axis)
        b = jax.lax.all_gather(b, axis, tiled=True)        # (W, 6, 6)
        g_p = jax.lax.all_gather(g_p, axis, tiled=True)    # (W, 6)
        e = jax.lax.all_gather(e, axis, tiled=True)        # (W, L, 6, 3)
        return b, c, e, g_p, g_x

    if problem.obs_weight is None:
        # static pytree for shard_map: materialize unit weights
        problem = problem._replace(
            obs_weight=jnp.ones((n_obs, 3), jnp.float32))

    # check_vma=False: every output IS replicated (psum or tiled all_gather
    # over disjoint slots), but the static analysis cannot infer it for the
    # all_gather-built B/E/g_p
    acc = shard_map(
        _accumulate,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def run(problem: BAProblem):
        def cost_fn(poses, landmarks):
            cost = total_cost(poses, landmarks, problem, huber_delta)
            if use_priors:
                r_pos, r_rot = prior_residuals(poses, problem)
                cost = cost + 0.5 * (
                    prior_position_weight * jnp.sum(r_pos * r_pos)
                    + prior_rotation_weight * jnp.sum(r_rot * r_rot)
                )
            return cost

        def add_prior_blocks(poses, b, g_p):
            if not use_priors:
                return b, g_p
            r_pos, r_rot = prior_residuals(poses, problem)
            j_pos, j_rot = prior_jacobians(poses)
            wv = problem.prior_valid.astype(jnp.float32)
            wp = prior_position_weight * wv
            wr = prior_rotation_weight * wv
            hi_q = jax.lax.Precision.HIGHEST
            b = b + (wp[:, None, None] * jnp.einsum("wij,wik->wjk", j_pos,
                                                    j_pos, precision=hi_q)
                     + wr[:, None, None] * jnp.einsum("wij,wik->wjk", j_rot,
                                                      j_rot, precision=hi_q))
            g_p = g_p + (wp[:, None] * jnp.einsum("wij,wi->wj", j_pos, r_pos,
                                                  precision=hi_q)
                         + wr[:, None] * jnp.einsum("wij,wi->wj", j_rot,
                                                    r_rot, precision=hi_q))
            return b, g_p

        def step(state, _):
            # single cost eval per iteration (matches ba.schur.solve_ba):
            # the accepted cost rides in the carry
            poses, landmarks, cost_before = state
            b, c, e, g_p, g_x = acc(
                poses, landmarks, problem.lm_valid,
                problem.obs_lm, problem.obs_point,
                problem.obs_valid, problem.obs_weight,
            )
            b, g_p = add_prior_blocks(poses, b, g_p)
            dp, dx = schur_solve(b, c, e, g_p, g_x, damping, anchor_first)
            new_poses = jax.vmap(se3.retract)(poses, dp)
            new_landmarks = jnp.where(
                problem.lm_valid[:, None], landmarks + dx, landmarks
            )
            cost_after = cost_fn(new_poses, new_landmarks)
            accept = cost_after < cost_before
            poses = jnp.where(accept, new_poses, poses)
            landmarks = jnp.where(accept, new_landmarks, landmarks)
            cost = jnp.where(accept, cost_after, cost_before)
            return (poses, landmarks, cost), cost_before

        cost0 = cost_fn(problem.poses, problem.landmarks)
        (poses, landmarks, final), trace = jax.lax.scan(
            step, (problem.poses, problem.landmarks, cost0), None,
            length=iters
        )
        return poses, landmarks, jnp.concatenate([trace, final[None]])

    return run(problem)


def solve_ba_sharded(
    problem: BAProblem,
    mesh: Mesh,
    iters: int = 5,
    damping: float = 1e-4,
    huber_delta: float = 0.5,
    anchor_first: bool = True,
    prior_position_weight: float = 0.0,
    prior_rotation_weight: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Drop-in distributed version of ba.schur.solve_ba.

    Same signature + a mesh; observations are sharded over the mesh axis and
    the normal blocks psum-reduced. Absolute-prior terms are unary in the
    (replicated) poses, so they are added once after the psum rather than
    inside the observation shards. Returns (poses, landmarks, cost_trace).
    """
    use_priors = problem.priors is not None and (
        prior_position_weight > 0 or prior_rotation_weight > 0
    )
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    problem = _pad_observations(problem, n_dev)

    def _accumulate(poses, landmarks, lm_valid, obs_kf, obs_lm, obs_pt,
                    obs_ok, obs_w):
        local = BAProblem(
            poses=poses, landmarks=landmarks, lm_valid=lm_valid,
            obs_kf=obs_kf, obs_lm=obs_lm, obs_point=obs_pt, obs_valid=obs_ok,
            obs_weight=obs_w,
        )
        blocks = accumulate_normal_blocks(poses, landmarks, local, huber_delta)
        return jax.tree.map(lambda x: jax.lax.psum(x, axis), blocks)

    acc = shard_map(
        _accumulate,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P(), P(), P()),
    )

    @jax.jit
    def run(problem: BAProblem):
        def cost_fn(poses, landmarks):
            cost = total_cost(poses, landmarks, problem, huber_delta)
            if use_priors:
                r_pos, r_rot = prior_residuals(poses, problem)
                cost = cost + 0.5 * (
                    prior_position_weight * jnp.sum(r_pos * r_pos)
                    + prior_rotation_weight * jnp.sum(r_rot * r_rot)
                )
            return cost

        def add_prior_blocks(poses, b, g_p):
            if not use_priors:
                return b, g_p
            r_pos, r_rot = prior_residuals(poses, problem)
            j_pos, j_rot = prior_jacobians(poses)
            wv = problem.prior_valid.astype(jnp.float32)
            wp = prior_position_weight * wv
            wr = prior_rotation_weight * wv
            hi_q = jax.lax.Precision.HIGHEST
            b = b + (wp[:, None, None] * jnp.einsum("wij,wik->wjk", j_pos,
                                                    j_pos, precision=hi_q)
                     + wr[:, None, None] * jnp.einsum("wij,wik->wjk", j_rot,
                                                      j_rot, precision=hi_q))
            g_p = g_p + (wp[:, None] * jnp.einsum("wij,wi->wj", j_pos, r_pos,
                                                  precision=hi_q)
                         + wr[:, None] * jnp.einsum("wij,wi->wj", j_rot,
                                                    r_rot, precision=hi_q))
            return b, g_p

        def step(state, _):
            # single cost eval per iteration (matches ba.schur.solve_ba)
            poses, landmarks, cost_before = state
            b, c, e, g_p, g_x = acc(
                poses, landmarks, problem.lm_valid,
                problem.obs_kf, problem.obs_lm, problem.obs_point,
                problem.obs_valid, problem.obs_weight,
            )
            b, g_p = add_prior_blocks(poses, b, g_p)
            dp, dx = schur_solve(b, c, e, g_p, g_x, damping, anchor_first)
            new_poses = jax.vmap(se3.retract)(poses, dp)
            new_landmarks = jnp.where(
                problem.lm_valid[:, None], landmarks + dx, landmarks
            )
            cost_after = cost_fn(new_poses, new_landmarks)
            accept = cost_after < cost_before
            poses = jnp.where(accept, new_poses, poses)
            landmarks = jnp.where(accept, new_landmarks, landmarks)
            cost = jnp.where(accept, cost_after, cost_before)
            return (poses, landmarks, cost), cost_before

        cost0 = cost_fn(problem.poses, problem.landmarks)
        (poses, landmarks, final), trace = jax.lax.scan(
            step, (problem.poses, problem.landmarks, cost0), None,
            length=iters
        )
        return poses, landmarks, jnp.concatenate([trace, final[None]])

    return run(problem)
