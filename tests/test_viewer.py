"""Viewer export: a standalone HTML file embedding the cloud."""

import base64

import numpy as np

from online_3d_reconstruction.io.viewer import export_html


def test_export_html_embeds_points(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 5, (500, 3)).astype(np.float32)
    cols = rng.random((500, 3)).astype(np.float32)
    traj = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    path = str(tmp_path / "v.html")
    export_html(path, pts, cols, traj)
    html = open(path).read()
    assert "<canvas" in html and "500 points" in html and "7 poses" in html
    b64 = html.split('atob("')[1].split('")')[0]
    decoded = np.frombuffer(base64.b64decode(b64), dtype=np.float32)
    np.testing.assert_array_equal(decoded.reshape(-1, 3), pts)


def test_export_subsamples(tmp_path):
    pts = np.zeros((1000, 3), np.float32)
    path = str(tmp_path / "v.html")
    export_html(path, pts, max_points=100)
    assert "100 points" in open(path).read()
