from online_3d_reconstruction.geometry import se3  # noqa: F401
from online_3d_reconstruction.geometry.backproject import (  # noqa: F401
    backproject_disparity,
    q_matrix,
)
