"""Checkpoint/resume: a resumed run must continue bit-for-bit equivalent."""

import numpy as np

from online_3d_reconstruction.io.dataset import SyntheticSequence
from online_3d_reconstruction.io.synthetic import nadir_pose
from online_3d_reconstruction.runtime.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from online_3d_reconstruction.runtime.pipeline import OnlineReconstructor

from tests.test_odometry import _test_config, vo_rig, vo_scene  # noqa: F401


def test_resume_matches_uninterrupted(vo_scene, vo_rig, tmp_path):
    cfg = _test_config()
    poses = [nadir_pose(0.8 * i, 0.1 * i, 12.0) for i in range(6)]
    dataset = SyntheticSequence(scene=vo_scene, rig=vo_rig, poses=poses)
    frames = [dataset[i] for i in range(6)]

    # run A: straight through
    eng_a = OnlineReconstructor(cfg, vo_rig)
    for f in frames:
        eng_a.process(f)
    res_a = eng_a.finish()

    # run B: snapshot after frame 2, restore into a fresh engine, continue
    eng_b1 = OnlineReconstructor(cfg, vo_rig)
    for f in frames[:3]:
        eng_b1.process(f)
    snap = str(tmp_path / "snap.npz")
    save_checkpoint(eng_b1, snap)

    eng_b2 = OnlineReconstructor(cfg, vo_rig)
    load_checkpoint(eng_b2, snap)
    assert eng_b2.frame_idx == 3
    for f in frames[3:]:
        eng_b2.process(f)
    res_b = eng_b2.finish()

    np.testing.assert_allclose(res_b.trajectory, res_a.trajectory,
                               rtol=1e-4, atol=1e-5)
    assert len(res_b.map_points) == len(res_a.map_points)
    np.testing.assert_array_equal(res_b.keyframe_indices, res_a.keyframe_indices)


def test_checkpoint_atomicity(vo_scene, vo_rig, tmp_path):
    """The snapshot file is either absent or complete (write-temp + rename)."""
    cfg = _test_config()
    dataset = SyntheticSequence(scene=vo_scene, rig=vo_rig,
                                poses=[nadir_pose(0, 0, 12.0)])
    eng = OnlineReconstructor(cfg, vo_rig)
    eng.process(dataset[0])
    snap = str(tmp_path / "sub" / "snap.npz")
    save_checkpoint(eng, snap)  # creates the directory
    import os
    assert os.path.exists(snap)
    leftovers = [f for f in os.listdir(tmp_path / "sub") if f.endswith(".tmp")]
    assert not leftovers
