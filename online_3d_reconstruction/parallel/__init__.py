from online_3d_reconstruction.parallel.mesh import make_mesh  # noqa: F401
from online_3d_reconstruction.parallel.ba_sharded import solve_ba_sharded  # noqa: F401
from online_3d_reconstruction.parallel.frames import batch_disparity  # noqa: F401
from online_3d_reconstruction.parallel.voxel_sharded import sharded_voxel_downsample  # noqa: F401
from online_3d_reconstruction.parallel.sgm_sharded import sharded_disparity  # noqa: F401
