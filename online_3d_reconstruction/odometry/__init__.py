from online_3d_reconstruction.odometry.rigid import (  # noqa: F401
    rigid_transform,
    ransac_rigid,
)
from online_3d_reconstruction.odometry.frontend import (  # noqa: F401
    FrameFeatures,
    extract_frame_features,
    lift_keypoints_to_3d,
    odometry_step,
)
