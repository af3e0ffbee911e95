"""Damped Gauss-Newton with a dense-block Schur complement — the BA solver.

North star mandate: "sparse CPU BA -> dense-block distributed Schur solve".
The normal equations H = [[B, E], [E^T, C]] are assembled *densely in the
block structure*: per-landmark 3x3 blocks C_j inverted in parallel, the
pose-landmark coupling E held as a dense (W, L, 6, 3) tensor (W ~ 8-128
keyframes, L <= max_landmarks: small), and the reduced camera system

    S = B - E C^{-1} E^T        (6W x 6W, dense)
    S dp = -g_p + E C^{-1} g_x
    dx_j = C_j^{-1} (-g_x_j - E_{.j}^T dp)

solved by Cholesky. Every accumulation is a ``segment_sum``/scatter-add and
every contraction an einsum — the shape matrix units want and the shape
that distributes: shard the observation list across devices, ``psum`` the
accumulated (B, C, E, g), solve the tiny reduced system replicated
(parallel/ba_sharded.py wires exactly that).

Gauge: the first pose's rows/columns of S are replaced by identity (exact
anchor), matching the reference's fixed-first-keyframe convention.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from online_3d_reconstruction.ba.problem import (
    BAProblem,
    huber_weights,
    jacobians,
    prior_jacobians,
    prior_residuals,
    residuals,
    total_cost,
)
from online_3d_reconstruction.geometry import se3


def accumulate_normal_blocks(poses, landmarks, problem: BAProblem,
                             huber_delta: float,
                             prior_position_weight: float = 0.0,
                             prior_rotation_weight: float = 0.0,
                             slot_major: int = 0):
    """One pass over the observation list -> (B, C, E, g_p, g_x).

    This is the part a multi-device solve shards: each device accumulates
    over its observation shard, then psums the outputs (they are plain sums).
    Absolute pose-prior terms (unary, dense in the pose blocks) are added
    directly to B and g_p when the problem carries priors and a weight is
    positive.

    ``slot_major`` (static) declares the observation list layout: when > 0,
    obs n belongs to pose slot n // slot_major (exactly ``slot_major`` obs
    per slot, the device-window layout of ba/device_tracks.py). That makes
    the per-pose accumulations plain reshaped sums and lets the landmark
    accumulations run as a ``lax.scan`` over slots with per-slot one-hots —
    O(N*L) FLOPs and O(slot_major*L) memory instead of the generic path's
    O(N*W*L) einsum, which is what makes W = 64-100 windows (SURVEY.md:424)
    tractable: at W=100/K=512/L=2048 the generic E-assembly alone would be
    ~47 GFLOP and a >400 MB one-hot; the slot-major path is ~2 GFLOP.
    """
    w_count = poses.shape[0]
    l_count = landmarks.shape[0]
    r = residuals(poses, landmarks, problem)              # (N, 3)
    w = problem.obs_valid.astype(jnp.float32)
    if huber_delta > 0:
        w = w * huber_weights(r, huber_delta, problem)
    if slot_major > 0:
        return _accumulate_slot_major(
            poses, landmarks, problem, r, w, slot_major,
            prior_position_weight, prior_rotation_weight)
    j_pose, j_point = jacobians(poses, landmarks, problem)
    # total row weight = validity * IRLS scalar * observation information:
    # J^T W J with W = w * W_obs, where W_obs is diagonal (N, 3) or the full
    # (N, 3, 3) stereo covariance inverse (ray-coupled noise model)
    if problem.obs_weight is not None and problem.obs_weight.ndim == 3:
        w_mat = w[:, None, None] * problem.obs_weight     # (N, 3, 3)
        hi_p = jax.lax.Precision.HIGHEST
        jp_w = jnp.einsum("nij,njk->nik", w_mat, j_pose,
                          precision=hi_p)                 # (N, 3, 6) = W J
        jx_w = jnp.einsum("nij,njk->nik", w_mat, j_point, precision=hi_p)
    else:
        wc = w[:, None]
        if problem.obs_weight is not None:
            wc = wc * problem.obs_weight                  # (N, 3)
        wj = wc[:, :, None]
        jp_w = j_pose * wj                                # (N, 3, 6)
        jx_w = j_point * wj                               # (N, 3, 3)
    # HIGHEST throughout: pose-math contractions quantized by a
    # reduced-precision default (bf16 on the earlier target, TF32 on the
    # GPU) corrupt the GN normal equations enough that the cost-decrease
    # guard rejects every step (observed on-accelerator: the whole window
    # BA silently became a no-op)
    hi = jax.lax.Precision.HIGHEST
    hp = jnp.einsum("nij,nik->njk", jp_w, j_pose, precision=hi)   # (N, 6, 6)
    hx = jnp.einsum("nij,nik->njk", jx_w, j_point, precision=hi)  # (N, 3, 3)
    e_obs = jnp.einsum("nij,nik->njk", jp_w, j_point, precision=hi)  # (N, 6, 3)
    gp_obs = jnp.einsum("nij,ni->nj", jp_w, r, precision=hi)      # (N, 6)
    gx_obs = jnp.einsum("nij,ni->nj", jx_w, r, precision=hi)      # (N, 3)
    # All index-based accumulations as one-hot contractions instead of
    # scatters (what segment_sum lowers to) (chosen for the earlier accelerator target; not yet measured on the H100). Sums
    # accumulate in f32, bit-identical to segment_sum.
    onehot_kf = (problem.obs_kf[:, None]
                 == jnp.arange(w_count, dtype=jnp.int32)[None, :]
                 ).astype(jnp.float32)                    # (N, W)
    onehot_lm = (problem.obs_lm[:, None]
                 == jnp.arange(l_count, dtype=jnp.int32)[None, :]
                 ).astype(jnp.float32)                    # (N, L)
    b_blocks = jnp.einsum("nw,njk->wjk", onehot_kf, hp, precision=hi)
    c_blocks = jnp.einsum("nl,njk->ljk", onehot_lm, hx, precision=hi)
    g_p = jnp.einsum("nw,nj->wj", onehot_kf, gp_obs, precision=hi)
    g_x = jnp.einsum("nl,nj->lj", onehot_lm, gx_obs, precision=hi)

    b_blocks, g_p = _add_prior_terms(poses, problem, b_blocks, g_p,
                                     prior_position_weight,
                                     prior_rotation_weight)
    # E is the (kf, lm) pair scatter. The contraction materializes an
    # (N, W, 6, 3) intermediate — fine for sliding windows (W ~ 8-16);
    # fall back to the scatter-add for very large W*N where that would
    # not fit. (Large windows should use slot_major instead.)
    n_obs = problem.obs_kf.shape[0]
    if n_obs * w_count * 18 * 4 <= (256 << 20):
        e_dense = jnp.einsum("nw,nl,njk->wljk", onehot_kf, onehot_lm,
                             e_obs, precision=hi)
    else:
        e_dense = jnp.zeros((w_count, l_count, 6, 3), dtype=jnp.float32)
        e_dense = e_dense.at[problem.obs_kf, problem.obs_lm].add(e_obs)
    return b_blocks, c_blocks, e_dense, g_p, g_x


def _add_prior_terms(poses, problem, b_blocks, g_p,
                     prior_position_weight, prior_rotation_weight):
    """Add the unary flight-log prior terms to (B, g_p) when enabled."""
    use_priors = problem.priors is not None and (
        prior_position_weight > 0 or prior_rotation_weight > 0
    )
    if not use_priors:
        return b_blocks, g_p
    r_pos, r_rot = prior_residuals(poses, problem)
    j_pos, j_rot = prior_jacobians(poses)
    wv = problem.prior_valid.astype(jnp.float32)
    wp = prior_position_weight * wv
    wr = prior_rotation_weight * wv
    hi_q = jax.lax.Precision.HIGHEST
    b_blocks = b_blocks + (
        wp[:, None, None] * jnp.einsum("wij,wik->wjk", j_pos, j_pos,
                                       precision=hi_q)
        + wr[:, None, None] * jnp.einsum("wij,wik->wjk", j_rot, j_rot,
                                         precision=hi_q)
    )
    g_p = g_p + (
        wp[:, None] * jnp.einsum("wij,wi->wj", j_pos, r_pos,
                                 precision=hi_q)
        + wr[:, None] * jnp.einsum("wij,wi->wj", j_rot, r_rot,
                                   precision=hi_q)
    )
    return b_blocks, g_p


def _accumulate_slot_major(poses, landmarks, problem: BAProblem,
                           r, w, k: int,
                           prior_position_weight, prior_rotation_weight):
    """Slot-major normal-block accumulation in analytic per-observation form.

    The layout contract: obs n belongs to pose slot n // k (exactly ``k``
    obs per slot — the device-window layout of ba/device_tracks.py). Two
    structural facts make this path fast at W = 64-100 (SURVEY.md:424):

    1. Within a slot the pose R is CONSTANT, and the residual Jacobian is
       J_pose = R^T [-I | hat(X)], J_point = R^T. Every normal-equation
       block therefore reduces to elementwise combinations of one 3x3 per
       observation, G = R W' R^T (W' = IRLS-weighted observation
       information in camera frame), the vector u = R W' r, and cross
       products with the landmark position X:

           B  += [[G, -G hat(X)], [(G hat(X))^T... sym, hat(X)^T G hat(X)]]
           C  +=  G          E += [-G; (G hat(X))^T]       (hat^T G = (G hat)^T)
           g_p += [-u; u x X]                               (hat(X)^T u)
           g_x +=  u

       No (N, 3, 6)/(N, 6, 6) tensors exist: the former jacobian-product
       einsums lowered to padded batched tiny matmuls on the earlier
       accelerator target; this form is pure elementwise math on (N, 3, 3)
       arrays (not yet measured against them on the H100).

    2. Per-POSE sums are contiguous reshaped reductions; only the
       per-LANDMARK sums need indexed accumulation, done as a ``lax.scan``
       over slots with per-slot (k, L) one-hots against ONE concatenated
       payload [G | u | G hat(X)] (21 floats) — never a full (N, L) buffer,
       and one one-hot read instead of three. The algebra is exactly the
       J-based form's, so results match the generic path to fp
       associativity.
    """
    hi = jax.lax.Precision.HIGHEST
    w_count = poses.shape[0]
    l_count = landmarks.shape[0]
    n = problem.obs_kf.shape[0]
    assert n == w_count * k, (n, w_count, k)

    # per-obs weighted information A = w * W_obs (camera frame)
    if problem.obs_weight is not None and problem.obs_weight.ndim == 3:
        a_mat = w[:, None, None] * problem.obs_weight          # (N, 3, 3)
    elif problem.obs_weight is not None:
        a_mat = (w[:, None] * problem.obs_weight)[:, :, None] \
            * jnp.eye(3, dtype=jnp.float32)[None]
    else:
        a_mat = w[:, None, None] * jnp.eye(3, dtype=jnp.float32)[None]

    rot = poses[:, :3, :3]                                     # (W, 3, 3)
    a_slot = a_mat.reshape(w_count, k, 3, 3)
    # G = R A R^T: two slot-batched contractions with the 3x3 R — the only
    # matmuls in the per-observation math
    ra = jnp.einsum("wab,wkbc->wkac", rot, a_slot, precision=hi)
    g_obs = jnp.einsum("wkac,wdc->wkad", ra, rot, precision=hi)  # (W, K, 3, 3)
    ar = jnp.einsum("nij,nj->ni", a_mat, r, precision=hi)      # A r
    u_obs = jnp.einsum("wab,wkb->wka", rot, ar.reshape(w_count, k, 3),
                       precision=hi)                           # (W, K, 3)

    # landmark position per obs (slot-major: one-hot-free would need a
    # gather; reuse the problem's one-hot-based gather only for X)
    onehot_lm_x = (problem.obs_lm[:, None]
                   == jnp.arange(l_count, dtype=jnp.int32)[None, :]
                   ).astype(jnp.float32)
    x = jnp.einsum("nl,lj->nj", onehot_lm_x, landmarks,
                   precision=hi).reshape(w_count, k, 3)

    # G hat(X): column j of hat(X) is a cross-product pattern, so each row i
    # of the product is cross(G[i, :], X)
    gh = jnp.cross(g_obs, x[:, :, None, :])                    # (W, K, 3, 3)
    # hat(X)^T M = columns cross(M[:, j], X)
    hthg = jnp.swapaxes(
        jnp.cross(jnp.swapaxes(gh, -1, -2), x[:, :, None, :]), -1, -2)
    hu = jnp.cross(u_obs, x)                                   # u x X

    # per-pose blocks: plain reshaped sums
    sg = g_obs.sum(axis=1)                                     # (W, 3, 3)
    sgh = gh.sum(axis=1)
    shthg = hthg.sum(axis=1)
    su = u_obs.sum(axis=1)
    shu = hu.sum(axis=1)
    b_blocks = jnp.concatenate([
        jnp.concatenate([sg, -sgh], axis=-1),
        jnp.concatenate([-jnp.swapaxes(sgh, -1, -2), shthg], axis=-1),
    ], axis=-2)                                                # (W, 6, 6)
    g_p = jnp.concatenate([-su, shu], axis=-1)                 # (W, 6)

    # per-landmark blocks: scan over slots, one one-hot contraction each.
    # Stacked per-slot outputs + post-scan sum (instead of a carry
    # accumulator) keep this scan legal inside shard_map, where a
    # replicated-zero carry fed by varying inputs trips the
    # varying-manual-axes check.
    payload = jnp.concatenate(
        [g_obs.reshape(w_count, k, 9), u_obs,
         gh.reshape(w_count, k, 9)], axis=-1)                  # (W, K, 21)
    lm_ids = jnp.arange(l_count, dtype=jnp.int32)

    def slot_body(_, inp):
        olm_w, pay_w = inp
        oh = (olm_w[:, None] == lm_ids[None, :]).astype(jnp.float32)
        return None, jnp.einsum("kl,kp->lp", oh, pay_w, precision=hi)

    _, acc = jax.lax.scan(
        slot_body, None, (problem.obs_lm.reshape(w_count, k), payload))
    c_blocks = acc[..., :9].sum(axis=0).reshape(l_count, 3, 3)
    g_x = acc[..., 9:12].sum(axis=0)
    g_wl = acc[..., :9].reshape(w_count, l_count, 3, 3)
    gh_wl = acc[..., 12:].reshape(w_count, l_count, 3, 3)
    e_dense = jnp.concatenate(
        [-g_wl, jnp.swapaxes(gh_wl, -1, -2)], axis=-2)         # (W, L, 6, 3)

    b_blocks, g_p = _add_prior_terms(poses, problem, b_blocks, g_p,
                                     prior_position_weight,
                                     prior_rotation_weight)
    return b_blocks, c_blocks, e_dense, g_p, g_x


def inv3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse via the adjugate.

    ``jnp.linalg.inv`` on a (L, 3, 3) batch lowers to a per-matrix LU
    factorization, which on the earlier accelerator target ran essentially
    serially. The adjugate is ~50 elementwise flops per matrix with no
    data-dependent control flow (not yet measured against the LU on the
    H100).
    Callers damp the diagonal, so conditioning is bounded away from zero.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    adj = jnp.stack([
        jnp.stack([co_a, c * h - b * i, b * f - c * e], axis=-1),
        jnp.stack([co_b, a * i - c * g, c * d - a * f], axis=-1),
        jnp.stack([co_c, b * g - a * h, a * e - b * d], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]


def schur_solve(b_blocks, c_blocks, e_dense, g_p, g_x,
                damping: float, anchor_first: bool):
    """Reduced-camera-system solve. Returns (dp (W,6), dx (L,3))."""
    w_count = b_blocks.shape[0]
    l_count = c_blocks.shape[0]
    eye3 = jnp.eye(3, dtype=jnp.float32)
    eye6 = jnp.eye(6, dtype=jnp.float32)

    c_damped = c_blocks + damping * eye3[None] + 1e-8 * eye3[None]
    c_inv = inv3x3(c_damped)                               # (L, 3, 3) batch

    hi = jax.lax.Precision.HIGHEST
    ec = jnp.einsum("wlij,ljk->wlik", e_dense, c_inv,
                    precision=hi)                          # (W, L, 6, 3)
    # S[a, j, b, m] = delta_ab (B + lambda I) - sum_l (E C^-1)_{al} E_{bl}^T
    s_coupling = jnp.einsum("aljk,blmk->ajbm", ec, e_dense, precision=hi)
    s_mat = -s_coupling
    diag_idx = jnp.arange(w_count)
    s_mat = s_mat.at[diag_idx, :, diag_idx, :].add(b_blocks + damping * eye6[None])

    rhs = -g_p + jnp.einsum("aljk,lk->aj", ec, g_x, precision=hi)  # (W, 6)

    if anchor_first:
        s_mat = s_mat.at[0, :, :, :].set(0.0)
        s_mat = s_mat.at[:, :, 0, :].set(0.0)
        s_mat = s_mat.at[0, jnp.arange(6), 0, jnp.arange(6)].set(1.0)
        rhs = rhs.at[0].set(0.0)

    s_full = s_mat.reshape(w_count * 6, w_count * 6)
    chol, lower = jax.scipy.linalg.cho_factor(s_full)
    dp = jax.scipy.linalg.cho_solve((chol, lower), rhs.reshape(-1)).reshape(w_count, 6)

    # back-substitute landmarks: dx_j = C_j^{-1} (-g_x - E^T dp)
    et_dp = jnp.einsum("wljk,wj->lk", e_dense, dp, precision=hi)   # (L, 3)
    dx = jnp.einsum("lij,lj->li", c_inv, -g_x - et_dp, precision=hi)
    return dp, dx


@partial(jax.jit, static_argnames=("iters", "damping", "huber_delta",
                                   "anchor_first", "prior_position_weight",
                                   "prior_rotation_weight", "slot_major"))
def solve_ba(problem: BAProblem, iters: int = 5, damping: float = 1e-4,
             huber_delta: float = 0.5, anchor_first: bool = True,
             prior_position_weight: float = 0.0,
             prior_rotation_weight: float = 0.0,
             slot_major: int = 0,
             ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run ``iters`` damped-GN steps. Returns (poses, landmarks, cost_trace).

    cost_trace has iters+1 entries (cost before each step and after the last)
    — the test suite asserts monotone decrease on synthetic problems.
    ``slot_major``: see accumulate_normal_blocks (large-window fast path).
    """
    use_priors = problem.priors is not None and (
        prior_position_weight > 0 or prior_rotation_weight > 0
    )

    def cost_fn(poses, landmarks):
        c = total_cost(poses, landmarks, problem, huber_delta)
        if use_priors:
            r_pos, r_rot = prior_residuals(poses, problem)
            c = c + 0.5 * (
                prior_position_weight * jnp.sum(r_pos * r_pos)
                + prior_rotation_weight * jnp.sum(r_rot * r_rot)
            )
        return c

    def step(state, _):
        # the accepted state's cost rides in the carry, so each iteration
        # evaluates the FULL residual pass once (for the candidate), not
        # twice — cost_before of step k+1 is cost_after of step k
        poses, landmarks, cost_before = state
        b_blocks, c_blocks, e_dense, g_p, g_x = accumulate_normal_blocks(
            poses, landmarks, problem, huber_delta,
            prior_position_weight, prior_rotation_weight,
            slot_major=slot_major,
        )
        dp, dx = schur_solve(b_blocks, c_blocks, e_dense, g_p, g_x,
                             damping, anchor_first)
        new_poses = jax.vmap(se3.retract)(poses, dp)
        new_landmarks = jnp.where(problem.lm_valid[:, None], landmarks + dx,
                                  landmarks)
        # reject a diverging step (cost-increase guard, LM-style)
        cost_after = cost_fn(new_poses, new_landmarks)
        accept = cost_after < cost_before
        poses = jnp.where(accept, new_poses, poses)
        landmarks = jnp.where(accept, new_landmarks, landmarks)
        cost = jnp.where(accept, cost_after, cost_before)
        return (poses, landmarks, cost), cost_before

    cost0 = cost_fn(problem.poses, problem.landmarks)
    (poses, landmarks, final_cost), trace = jax.lax.scan(
        step, (problem.poses, problem.landmarks, cost0), None, length=iters
    )
    return poses, landmarks, jnp.concatenate([trace, final_cost[None]])
