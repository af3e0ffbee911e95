from online_3d_reconstruction.utils.imaging import bilinear_sample_np  # noqa: F401
