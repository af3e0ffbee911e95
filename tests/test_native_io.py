"""Native C++ IO runtime: decode correctness + ordered prefetching."""

import numpy as np
import pytest

from online_3d_reconstruction.io import native_loader


pytestmark = pytest.mark.skipif(
    not native_loader.available(), reason="native IO library not built"
)


def _write_pgm(path, img):
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def _write_ppm(path, img):
    with open(path, "wb") as f:
        f.write(f"P6\n# comment\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


class TestDecode:
    def test_npy_float_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        img = rng.random((17, 23), dtype=np.float32)
        p = str(tmp_path / "a.npy")
        np.save(p, img)
        out = native_loader.read_image(p)
        np.testing.assert_array_equal(out, img)

    def test_npy_rgb_uint8(self, tmp_path):
        rng = np.random.default_rng(1)
        img = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
        p = str(tmp_path / "b.npy")
        np.save(p, img)
        out = native_loader.read_image(p)
        np.testing.assert_array_equal(out, img)

    def test_pgm(self, tmp_path):
        rng = np.random.default_rng(2)
        img = rng.integers(0, 256, (11, 13), dtype=np.uint8)
        p = str(tmp_path / "c.pgm")
        _write_pgm(p, img)
        out = native_loader.read_image(p)
        np.testing.assert_array_equal(out, img)

    def test_ppm_with_comment(self, tmp_path):
        rng = np.random.default_rng(3)
        img = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
        p = str(tmp_path / "d.ppm")
        _write_ppm(p, img)
        out = native_loader.read_image(p)
        np.testing.assert_array_equal(out, img)

    def test_png_byte_exact_vs_cv2(self, tmp_path):
        """PNG (the real camera format, SURVEY.md C2): gray + color decode
        must match cv2.imread byte for byte (PNG is lossless)."""
        cv2 = pytest.importorskip("cv2")
        rng = np.random.default_rng(3)
        g = rng.integers(0, 256, (31, 45), dtype=np.uint8)
        pg = str(tmp_path / "g.png")
        cv2.imwrite(pg, g)
        np.testing.assert_array_equal(native_loader.read_image(pg), g)
        c = rng.integers(0, 256, (31, 45, 3), dtype=np.uint8)
        pc = str(tmp_path / "c.png")
        cv2.imwrite(pc, c[:, :, ::-1])  # cv2 writes BGR; we decode to RGB
        np.testing.assert_array_equal(native_loader.read_image(pc), c)

    def test_jpeg_matches_cv2_decode(self, tmp_path):
        """JPEG decode agrees with cv2's own libjpeg decode of the file."""
        cv2 = pytest.importorskip("cv2")
        rng = np.random.default_rng(4)
        c = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
        p = str(tmp_path / "c.jpg")
        cv2.imwrite(p, c[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 92])
        out = native_loader.read_image(p)
        ref = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1

    def test_missing_file_error(self, tmp_path):
        with pytest.raises(IOError):
            native_loader.read_image(str(tmp_path / "missing.npy"))

    def test_garbage_format_error(self, tmp_path):
        p = str(tmp_path / "junk.bin")
        open(p, "wb").write(b"not an image at all")
        with pytest.raises(IOError):
            native_loader.read_image(p)


class TestPrefetcher:
    def test_ordered_stream(self, tmp_path):
        rng = np.random.default_rng(4)
        paths = []
        imgs = []
        for i in range(20):
            img = rng.random((8, 10), dtype=np.float32) + i
            p = str(tmp_path / f"{i:03d}.npy")
            np.save(p, img)
            paths.append(p)
            imgs.append(img)
        pf = native_loader.NativePrefetcher(paths, depth=3, threads=3)
        got = list(pf)
        pf.close()
        assert len(got) == 20
        for a, b in zip(got, imgs):
            np.testing.assert_array_equal(a, b)

    def test_error_frame_raises(self, tmp_path):
        good = str(tmp_path / "0.npy")
        np.save(good, np.zeros((4, 4), np.float32))
        bad = str(tmp_path / "1.npy")
        open(bad, "wb").write(b"junk")
        pf = native_loader.NativePrefetcher([good, bad], depth=2)
        it = iter(pf)
        next(it)
        with pytest.raises(IOError):
            next(it)
        pf.close()
