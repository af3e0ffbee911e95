import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.geometry import se3


def random_pose(rng):
    phi = rng.normal(0, 0.8, size=3)
    rho = rng.normal(0, 2.0, size=3)
    return np.asarray(se3.exp(jnp.asarray(np.concatenate([rho, phi]), dtype=jnp.float32)))


def test_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(10):
        xi = rng.normal(0, 0.7, size=6).astype(np.float32)
        pose = se3.exp(jnp.asarray(xi))
        xi_back = se3.log(pose)
        np.testing.assert_allclose(np.asarray(xi_back), xi, atol=1e-4)


def test_exp_zero_is_identity():
    pose = se3.exp(jnp.zeros(6, dtype=jnp.float32))
    np.testing.assert_allclose(np.asarray(pose), np.eye(4), atol=1e-6)


def test_rotation_is_orthonormal():
    rng = np.random.default_rng(1)
    pose = random_pose(rng)
    rot = pose[:3, :3]
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(rot) - 1.0) < 1e-5


def test_inverse_compose():
    rng = np.random.default_rng(2)
    pose = jnp.asarray(random_pose(rng))
    composed = se3.compose(pose, se3.inverse(pose))
    np.testing.assert_allclose(np.asarray(composed), np.eye(4), atol=1e-5)


def test_transform_points_matches_numpy():
    rng = np.random.default_rng(3)
    pose = random_pose(rng)
    pts = rng.normal(0, 5, size=(50, 3)).astype(np.float32)
    ours = np.asarray(se3.transform_points(jnp.asarray(pose), jnp.asarray(pts)))
    expected = pts @ pose[:3, :3].T + pose[:3, 3]
    np.testing.assert_allclose(ours, expected, atol=1e-4)


def test_geodesic_distance():
    xi = jnp.array([1.0, 0.0, 0.0, 0.0, 0.0, 0.3], dtype=jnp.float32)
    pose = se3.exp(xi)
    t_err, r_err = se3.geodesic_distance(se3.identity(), pose)
    assert abs(float(r_err) - 0.3) < 1e-4
    assert float(t_err) > 0.5


def test_euler_identity():
    rot = se3.euler_to_rotation(jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
    np.testing.assert_allclose(np.asarray(rot), np.eye(3), atol=1e-6)


def test_euler_yaw_90():
    rot = np.asarray(se3.euler_to_rotation(jnp.float32(0), jnp.float32(0), jnp.float32(np.pi / 2)))
    np.testing.assert_allclose(rot @ np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), atol=1e-6)


def test_quaternion_matches_exp():
    rng = np.random.default_rng(4)
    phi = rng.normal(0, 0.5, size=3)
    theta = np.linalg.norm(phi)
    axis = phi / theta
    quat = np.concatenate([[np.cos(theta / 2)], np.sin(theta / 2) * axis]).astype(np.float32)
    rot_q = np.asarray(se3.quaternion_to_rotation(jnp.asarray(quat)))
    rot_e = np.asarray(se3.exp_so3(jnp.asarray(phi.astype(np.float32))))
    np.testing.assert_allclose(rot_q, rot_e, atol=1e-5)
