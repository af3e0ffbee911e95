from online_3d_reconstruction.features.fast import detect_keypoints, fast_score  # noqa: F401
from online_3d_reconstruction.features.brief import (  # noqa: F401
    Keypoints,
    describe_keypoints,
    detect_and_describe,
)
from online_3d_reconstruction.features.match import match_descriptors, hamming_matrix  # noqa: F401
