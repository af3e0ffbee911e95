from online_3d_reconstruction.io.calibration import (  # noqa: F401
    CameraIntrinsics,
    StereoCalibration,
    RectifiedRig,
    stereo_rectify,
    init_undistort_rectify_map,
)
from online_3d_reconstruction.io.synthetic import (  # noqa: F401
    SyntheticScene,
    make_orbit_trajectory,
    make_survey_trajectory,
)
