from online_3d_reconstruction.stereo.rectify import remap_bilinear, rectify_pair  # noqa: F401
from online_3d_reconstruction.stereo.census import census_transform, cost_volume  # noqa: F401
from online_3d_reconstruction.stereo.sgm import sgm_disparity  # noqa: F401
