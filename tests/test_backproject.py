import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.geometry import se3
from online_3d_reconstruction.geometry.backproject import (
    backproject_disparity,
    q_matrix,
)


def test_backproject_recovers_gt_depth(stereo_frame, small_rig):
    cloud = backproject_disparity(
        jnp.asarray(stereo_frame.gt_disparity),
        jnp.asarray(stereo_frame.left_rgb),
        jnp.asarray(small_rig.q, dtype=jnp.float32),
        stride=1,
        min_depth=1.0,
        max_depth=100.0,
    )
    z = np.asarray(cloud.points[:, 2]).reshape(stereo_frame.depth.shape)
    valid = np.asarray(cloud.valid).reshape(stereo_frame.depth.shape)
    assert valid.mean() > 0.95
    err = np.abs(z - stereo_frame.depth)[valid]
    assert err.max() < 1e-2


def test_backprojected_points_lie_on_scene(stereo_frame, small_rig, scene):
    """Transform the cloud to world: ground points must satisfy z ~= 0 or a
    plateau height."""
    cloud = backproject_disparity(
        jnp.asarray(stereo_frame.gt_disparity),
        jnp.asarray(stereo_frame.left_rgb),
        jnp.asarray(small_rig.q, dtype=jnp.float32),
        stride=2,
        min_depth=1.0,
        max_depth=100.0,
    )
    world = se3.transform_points(jnp.asarray(stereo_frame.pose), cloud.points)
    z_world = np.asarray(world[:, 2])[np.asarray(cloud.valid)]
    heights = np.array([0.0] + [p.height for p in scene.plateaus])
    dist_to_surface = np.min(np.abs(z_world[:, None] - heights[None, :]), axis=1)
    assert np.percentile(dist_to_surface, 99) < 0.05


def test_q_matrix_matches_identity_rig(small_rig):
    q = q_matrix(small_rig.fx, small_rig.fy, small_rig.cx, small_rig.cy,
                 small_rig.baseline)
    np.testing.assert_allclose(np.asarray(q), small_rig.q, atol=1e-6)


def test_stride_and_masking():
    disp = jnp.full((16, 16), 4.0)
    disp = disp.at[0, 0].set(-1.0)   # invalid marker
    color = jnp.ones((16, 16, 3))
    q = q_matrix(100.0, 100.0, 8.0, 8.0, 0.5)
    cloud = backproject_disparity(disp, color, q, stride=2, min_depth=0.1, max_depth=1e4)
    assert cloud.points.shape == (64, 3)
    assert not bool(cloud.valid[0])  # the invalid pixel survives the stride
    assert int(jnp.sum(cloud.valid)) == 63


def test_color_substride_serves_point_blocks():
    """A color plane s x coarser than the point grid (MappingConfig.
    color_stride) colors each s x s point block with its texel — geometry is
    untouched, only the color assignment coarsens."""
    disp = jnp.full((16, 16), 4.0)
    q = q_matrix(100.0, 100.0, 8.0, 8.0, 0.5)
    # color at stride 4 on a stride-2 point grid: (4, 4) plane, substride 2
    color = jnp.arange(16, dtype=jnp.float32).reshape(4, 4)[..., None].repeat(3, -1) / 16.0
    cloud = backproject_disparity(disp, color, q, stride=2,
                                  min_depth=0.1, max_depth=1e4,
                                  color_prestrided=True, color_substride=2)
    fine = backproject_disparity(disp, jnp.repeat(jnp.repeat(color, 2, 0), 2, 1),
                                 q, stride=2, min_depth=0.1, max_depth=1e4,
                                 color_prestrided=True)
    np.testing.assert_allclose(np.asarray(cloud.colors), np.asarray(fine.colors))
    np.testing.assert_allclose(np.asarray(cloud.points), np.asarray(fine.points))


def test_color_stride_validation():
    import dataclasses

    import pytest

    from online_3d_reconstruction.config import MappingConfig
    from online_3d_reconstruction.runtime.pipeline import _color_stride

    assert _color_stride(MappingConfig(frame_point_stride=2)) == 2
    assert _color_stride(MappingConfig(frame_point_stride=2, color_stride=4)) == 4
    with pytest.raises(ValueError, match="color_stride"):
        _color_stride(MappingConfig(frame_point_stride=2, color_stride=3))
