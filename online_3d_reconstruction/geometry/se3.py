"""SE(3) rigid-transform utilities.

The reference moves poses around as Eigen/OpenCV 4x4 matrices and transforms
clouds with ``pcl::transformPointCloud`` (SURVEY.md §1 L3, §2.1 C12). Here a
pose is a ``(4, 4)`` float32 array (world-from-camera unless noted), and all
ops are jit/vmap-friendly pure functions. Tangent vectors are ``(6,)`` with
translation first: ``xi = [rho, phi]``, ``exp(xi) = [[exp(phi), V rho],[0,1]]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Matrix product at HIGHEST precision: pose matrices are tiny (3x3/4x4)
    and never matmul-bound, but a reduced-precision default (TF32 on the
    GPU) would quantize poses; force full fp32 everywhere in pose math."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def identity() -> jnp.ndarray:
    return jnp.eye(4, dtype=jnp.float32)


def from_rt(rotation: jnp.ndarray, translation: jnp.ndarray) -> jnp.ndarray:
    """Build a 4x4 transform from a 3x3 rotation and 3-vector translation."""
    top = jnp.concatenate([rotation, translation.reshape(3, 1)], axis=1)
    bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype)
    return jnp.concatenate([top, bottom], axis=0)


def rotation(transform: jnp.ndarray) -> jnp.ndarray:
    return transform[..., :3, :3]


def translation(transform: jnp.ndarray) -> jnp.ndarray:
    return transform[..., :3, 3]


def inverse(transform: jnp.ndarray) -> jnp.ndarray:
    rot = rotation(transform)
    rot_t = jnp.swapaxes(rot, -1, -2)
    trans = translation(transform)
    inv_t = -jnp.einsum("...ij,...j->...i", rot_t, trans, precision=jax.lax.Precision.HIGHEST)
    out = jnp.zeros_like(transform)
    out = out.at[..., :3, :3].set(rot_t)
    out = out.at[..., :3, 3].set(inv_t)
    out = out.at[..., 3, 3].set(1.0)
    return out


def compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a then-applied-to b, i.e. the matrix product a @ b."""
    return _mm(a, b)


def transform_points(transform: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Apply a 4x4 transform to an (..., N, 3) point array.

    The replacement for ``pcl::transformPointCloud``: a single fused
    matmul + bias add, batched over leading axes.
    """
    rot = rotation(transform)
    trans = translation(transform)
    # HIGHEST precision: a reduced-precision default (TF32 on the GPU) would
    # quantize world coordinates; this matvec is tiny, never matmul-bound.
    return (
        jnp.einsum("...ij,...nj->...ni", rot, points, precision=jax.lax.Precision.HIGHEST)
        + trans[..., None, :]
    )


def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: 3-vector -> skew-symmetric 3x3."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula, Taylor-safe at theta -> 0 (grad-safe via where)."""
    theta_sq = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta_sq, _EPS))
    safe = theta_sq > _EPS
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks near zero.
    a = jnp.where(safe, jnp.sin(theta) / theta, 1.0 - theta_sq / 6.0)
    b = jnp.where(safe, (1.0 - jnp.cos(theta)) / jnp.maximum(theta_sq, _EPS), 0.5 - theta_sq / 24.0)
    skew = hat(phi)
    skew_sq = _mm(skew, skew)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), skew.shape)
    return eye + a[..., None, None] * skew + b[..., None, None] * skew_sq


def log_so3(rot: jnp.ndarray) -> jnp.ndarray:
    """Inverse of exp_so3 (principal branch, |theta| < pi)."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_theta)
    vee = jnp.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        axis=-1,
    )
    scale = jnp.where(theta > 1e-5, theta / (2.0 * jnp.sin(theta)), 0.5 + theta * theta / 12.0)
    return scale[..., None] * vee


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exponential. xi = [rho(3), phi(3)] -> 4x4 transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    rot = exp_so3(phi)
    theta_sq = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta_sq, _EPS))
    safe = theta_sq > _EPS
    b = jnp.where(safe, (1.0 - jnp.cos(theta)) / jnp.maximum(theta_sq, _EPS), 0.5 - theta_sq / 24.0)
    c = jnp.where(
        safe,
        (theta - jnp.sin(theta)) / jnp.maximum(theta_sq * theta, _EPS),
        1.0 / 6.0 - theta_sq / 120.0,
    )
    skew = hat(phi)
    skew_sq = _mm(skew, skew)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), rot.shape)
    v_mat = eye + b[..., None, None] * skew + c[..., None, None] * skew_sq
    trans = jnp.einsum("...ij,...j->...i", v_mat, rho,
                       precision=jax.lax.Precision.HIGHEST)
    out = jnp.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype)
    out = out.at[..., :3, :3].set(rot)
    out = out.at[..., :3, 3].set(trans)
    out = out.at[..., 3, 3].set(1.0)
    return out


def log(transform: jnp.ndarray) -> jnp.ndarray:
    """se(3) logarithm: 4x4 transform -> [rho, phi]."""
    phi = log_so3(rotation(transform))
    theta_sq = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta_sq, _EPS))
    safe = theta_sq > _EPS
    b = jnp.where(safe, (1.0 - jnp.cos(theta)) / jnp.maximum(theta_sq, _EPS), 0.5 - theta_sq / 24.0)
    c = jnp.where(
        safe,
        (theta - jnp.sin(theta)) / jnp.maximum(theta_sq * theta, _EPS),
        1.0 / 6.0 - theta_sq / 120.0,
    )
    skew = hat(phi)
    skew_sq = _mm(skew, skew)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=transform.dtype), skew.shape)
    v_mat = eye + b[..., None, None] * skew + c[..., None, None] * skew_sq
    rho = jnp.linalg.solve(v_mat, translation(transform)[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def retract(transform: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative update: exp(xi) @ T (the BA update rule)."""
    return _mm(exp(xi), transform)


def geodesic_distance(a: jnp.ndarray, b: jnp.ndarray):
    """(translation metres, rotation radians) between two poses."""
    rel = _mm(inverse(a), b)
    t_err = jnp.linalg.norm(translation(rel), axis=-1)
    r_err = jnp.linalg.norm(log_so3(rotation(rel)), axis=-1)
    return t_err, r_err


def euler_to_rotation(roll: jnp.ndarray, pitch: jnp.ndarray, yaw: jnp.ndarray) -> jnp.ndarray:
    """ZYX (yaw-pitch-roll) Euler angles -> rotation matrix.

    Matches the aerospace convention a UAV flight log uses (SURVEY.md §2.1 C3).
    """
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    rz = jnp.stack(
        [
            jnp.stack([cy, -sy, jnp.zeros_like(cy)], -1),
            jnp.stack([sy, cy, jnp.zeros_like(cy)], -1),
            jnp.stack([jnp.zeros_like(cy), jnp.zeros_like(cy), jnp.ones_like(cy)], -1),
        ],
        -2,
    )
    ry = jnp.stack(
        [
            jnp.stack([cp, jnp.zeros_like(cp), sp], -1),
            jnp.stack([jnp.zeros_like(cp), jnp.ones_like(cp), jnp.zeros_like(cp)], -1),
            jnp.stack([-sp, jnp.zeros_like(cp), cp], -1),
        ],
        -2,
    )
    rx = jnp.stack(
        [
            jnp.stack([jnp.ones_like(cr), jnp.zeros_like(cr), jnp.zeros_like(cr)], -1),
            jnp.stack([jnp.zeros_like(cr), cr, -sr], -1),
            jnp.stack([jnp.zeros_like(cr), sr, cr], -1),
        ],
        -2,
    )
    return _mm(rz, _mm(ry, rx))


def quaternion_to_rotation(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )
