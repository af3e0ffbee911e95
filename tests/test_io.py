"""IO round-trips: PLY/PCD/TUM export, flight-log parsing, image-folder data."""

import os

import numpy as np
import pytest

from online_3d_reconstruction.io.dataset import (
    ImageFolderSequence,
    flight_log_poses,
    gps_to_local,
    load_flight_log,
    match_poses_to_timestamps,
)
from online_3d_reconstruction.io.export import (
    load_ply,
    load_trajectory_tum,
    save_pcd,
    save_ply,
    save_trajectory_tum,
)


class TestExport:
    @pytest.mark.parametrize("binary", [True, False])
    def test_ply_roundtrip(self, tmp_path, binary):
        rng = np.random.default_rng(0)
        pts = rng.normal(0, 5, (100, 3)).astype(np.float32)
        cols = rng.random((100, 3)).astype(np.float32)
        path = str(tmp_path / "m.ply")
        save_ply(path, pts, cols, binary=binary)
        pts2, cols2 = load_ply(path)
        np.testing.assert_allclose(pts2, pts, rtol=1e-6)
        np.testing.assert_allclose(cols2 / 255.0, cols, atol=1 / 255.0 + 1e-6)

    def test_pcd_header_and_size(self, tmp_path):
        pts = np.zeros((10, 3), np.float32)
        path = str(tmp_path / "m.pcd")
        save_pcd(path, pts)
        blob = open(path, "rb").read()
        head = blob.split(b"DATA binary\n")[0].decode()
        assert "POINTS 10" in head and "FIELDS x y z rgb" in head
        assert len(blob.split(b"DATA binary\n")[1]) == 10 * 16

    def test_tum_roundtrip(self, tmp_path):
        from online_3d_reconstruction.io.synthetic import nadir_pose

        poses = np.stack([nadir_pose(i, 2 * i, 30.0, yaw=0.1 * i) for i in range(5)])
        path = str(tmp_path / "t.tum")
        save_trajectory_tum(path, poses)
        times, poses2 = load_trajectory_tum(path)
        np.testing.assert_allclose(poses2, poses, atol=1e-4)


class TestFlightLog:
    def test_gps_to_local_scale(self):
        # one degree of latitude ~ 111.19 km
        xyz = gps_to_local(np.array([10.0, 10.001]), np.array([20.0, 20.0]),
                           np.array([100.0, 110.0]))
        assert abs(xyz[1, 1] - 111.19) < 0.5 or abs(xyz[1, 1] - 111194.9) / 111194.9 < 0.01
        assert abs(xyz[1, 2] - 10.0) < 1e-9

    def test_parse_and_poses(self, tmp_path):
        path = str(tmp_path / "log.csv")
        with open(path, "w") as f:
            f.write("timestamp,x,y,z,roll,pitch,yaw\n")
            for i in range(4):
                f.write(f"{i * 0.1},{i},{2 * i},{30},0,0,{0.1 * i}\n")
        log = load_flight_log(path)
        poses = flight_log_poses(log)
        assert poses.shape == (4, 4, 4)
        np.testing.assert_allclose(poses[2, :3, 3], [2, 4, 30], atol=1e-6)
        # yaw rotation present
        assert abs(poses[3, 0, 0] - np.cos(0.3)) < 1e-5

    def test_timestamp_matching(self):
        pose_t = np.array([0.0, 0.1, 0.2, 0.3])
        img_t = np.array([0.11, 0.29, 5.0])
        idx = match_poses_to_timestamps(pose_t, img_t, max_dt=0.05)
        assert idx[0] == 1
        assert idx[1] == 3
        assert idx[2] == -1  # too far: unmatched


class TestImageFolder:
    def test_npy_folder_dataset(self, tmp_path):
        rng = np.random.default_rng(1)
        for sub in ("left", "right"):
            os.makedirs(tmp_path / sub)
        for i in range(3):
            t = f"{i * 0.1:.3f}"
            np.save(tmp_path / "left" / f"{t}.npy", rng.random((16, 24)).astype(np.float32))
            np.save(tmp_path / "right" / f"{t}.npy", rng.random((16, 24)).astype(np.float32))
        with open(tmp_path / "log.csv", "w") as f:
            f.write("timestamp,x,y,z\n")
            for i in range(3):
                f.write(f"{i * 0.1},{i},0,30\n")
        ds = ImageFolderSequence(
            left_dir=str(tmp_path / "left"), right_dir=str(tmp_path / "right"),
            flight_log=str(tmp_path / "log.csv"),
        )
        assert len(ds) == 3
        frame = ds[1]
        assert frame.left.shape == (16, 24)
        assert frame.color.shape == (16, 24, 3)
        np.testing.assert_allclose(frame.prior_pose[:3, 3], [1, 0, 30], atol=1e-5)

    def test_format_without_opencv_names_the_native_formats(self, tmp_path,
                                                           monkeypatch):
        """Where cv2 is not installed, a format the native decoder does not
        read fails with an IOError that lists the formats it does."""
        import sys

        path = tmp_path / "frame.bmp"
        path.write_bytes(b"BM")
        monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
        with pytest.raises(IOError, match=r"\.png \.jpg \.jpeg.*cv2"):
            ImageFolderSequence._load_image(str(path))
