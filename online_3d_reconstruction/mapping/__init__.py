from online_3d_reconstruction.mapping.voxel import voxel_downsample  # noqa: F401
from online_3d_reconstruction.mapping.global_map import (  # noqa: F401
    GlobalMap,
    create_map,
    insert_cloud,
    downsample_map,
    map_to_numpy,
)
