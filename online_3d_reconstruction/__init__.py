"""online_3d_reconstruction — an online 3D reconstruction engine on the GPU.

A from-scratch JAX/XLA framework, with a CUDA kernel where XLA falls short, with the capabilities of the
reference ``pk17r/online_3d_reconstruction`` (C++/OpenCV/PCL/CUDA): streaming
stereo rectification + SGM disparity, disparity->point-cloud backprojection,
ORB-style feature detection + descriptor matching for inter-frame pose
correction, local bundle adjustment over keyframe poses, and voxel-grid
fusion into a global map — redesigned for an accelerator:

- SGM cost-volume aggregation as a CUDA kernel (one warp per path, the
  recurrence in registers) on the GPU, with the ``lax.scan`` reference on
  the CPU.
- Brute-force Hamming descriptor matching as a batched (+/-1) matmul
  followed by min/argmin passes.
- Local BA as a dense-block Schur-complement Gauss-Newton solve, sharded
  over keyframes/observations with ``psum`` collectives.
- PCL-style voxel downsampling as sort-by-key + segment-sum scatter
  reduction.
- Multi-chip scaling via ``jax.sharding.Mesh`` + ``shard_map`` (frame-batch,
  keyframe-sharded BA, voxel-block spatial sharding, image row-slab tiling).

Reference provenance: the upstream source mount was empty during the survey
and this build (see SURVEY.md §0); capability parity targets derive from the
driver's north-star contract (BASELINE.json:5) and SURVEY.md §2.
"""

__version__ = "0.1.0"

from online_3d_reconstruction.config import (  # noqa: F401
    PipelineConfig,
    StereoConfig,
    FeatureConfig,
    MatchConfig,
    OdometryConfig,
    BAConfig,
    MappingConfig,
    RuntimeConfig,
    load_config,
)


def __getattr__(name):
    """Lazy top-level API (keeps `import online_3d_reconstruction` free of
    jax-touching imports): reconstruct, OnlineReconstructor, stereo/odometry/
    ba/mapping/parallel submodule entry points per SURVEY.md §3.6."""
    lazy = {
        "reconstruct": ("online_3d_reconstruction.runtime.pipeline", "reconstruct"),
        "OnlineReconstructor": ("online_3d_reconstruction.runtime.pipeline", "OnlineReconstructor"),
        "reconstruct_distributed": ("online_3d_reconstruction.runtime.distributed", "reconstruct_distributed"),
        "sgm_disparity": ("online_3d_reconstruction.stereo.sgm", "sgm_disparity"),
        "detect_and_describe": ("online_3d_reconstruction.features.brief", "detect_and_describe"),
        "match_descriptors": ("online_3d_reconstruction.features.match", "match_descriptors"),
        "odometry_step": ("online_3d_reconstruction.odometry.frontend", "odometry_step"),
        "solve_ba": ("online_3d_reconstruction.ba.schur", "solve_ba"),
        "voxel_downsample": ("online_3d_reconstruction.mapping.voxel", "voxel_downsample"),
        "make_mesh": ("online_3d_reconstruction.parallel.mesh", "make_mesh"),
    }
    if name in lazy:
        import importlib

        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
