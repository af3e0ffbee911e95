"""Multi-host / multi-chip reconstruction — the ``o3r.distributed.run`` path.

The reference is strictly single-machine (SURVEY.md §2.4); this module is the
new framework's scale-out entry point (config [B:11]):

- ``initialize(...)`` wraps ``jax.distributed.initialize`` for multi-host
  process groups (call once per process before any jax op; no-op for
  single-host multi-chip).
- ``reconstruct_distributed(dataset, config, rig, mesh)`` runs the online
  loop with the sharded stages swapped in: row-slab SGM with halo exchange
  (P4), observation-sharded BA with psum Schur reduction (P2). Every process
  must iterate the same dataset (SPMD: all processes execute each global
  collective); results are identical on every process.

The map pool stays process-local in v1 (the sharded voxel merge op,
parallel/voxel_sharded.py, is used for the final global reduction).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
from jax.sharding import Mesh

from online_3d_reconstruction.ba.window import WindowBA
from online_3d_reconstruction.config import PipelineConfig
from online_3d_reconstruction.geometry.backproject import backproject_disparity
from online_3d_reconstruction.io.calibration import RectifiedRig
from online_3d_reconstruction.odometry.frontend import extract_frame_features
from online_3d_reconstruction.parallel.ba_sharded import solve_ba_sharded
from online_3d_reconstruction.parallel.sgm_sharded import sharded_disparity
from online_3d_reconstruction.runtime.pipeline import (
    OnlineReconstructor,
    ReconstructionResult,
)
from online_3d_reconstruction.stereo.rectify import (
    rectify_pair,
    remap_bilinear,
    remap_bilinear_banded,
)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the multi-host process group (before any other jax call)."""
    if coordinator_address is None:
        return  # single host: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


class DistributedReconstructor(OnlineReconstructor):
    """Online loop whose stereo + BA stages run sharded over a device mesh.

    The BA backend is the same device-resident ``WindowState`` as the
    single-chip loop — the track build + problem packing are pure device
    code (ba/device_tracks.py), only the Schur solve inside it swaps for
    the observation-sharded psum reduction (parallel/ba_sharded.py). A
    keyframe event therefore stays O(1) dispatches; the earlier design
    forced the host track-table (host_ba), paying a device_get plus ~10
    round trips per keyframe. ``runtime.host_ba=True`` still selects the
    host backend explicitly (it then uses the sharded solver too).
    """

    def __init__(self, config: PipelineConfig, rig: RectifiedRig, mesh: Mesh,
                 sgm_halo: int = 32):
        super().__init__(config, rig)
        self.mesh = mesh
        self.sgm_halo = sgm_halo
        if self._ba is not None:
            self._ba = WindowBA(
                config.ba,
                solver=functools.partial(solve_ba_sharded, mesh=mesh),
            )

    def _sharded_frame(self, packed, kf, precomputed_disp):
        """Per-frame sharded stages: stereo (P4) + features + tracking."""
        import jax.numpy as jnp

        from online_3d_reconstruction.odometry.frontend import tracking_step
        from online_3d_reconstruction.runtime.pipeline import (
            _color_stride,
            unpack_frame,
        )

        cfg = self.cfg
        cc = _color_stride(cfg.mapping)   # the stride pack() wrote color at
        prior, frame_idx, left, right, color, disp_in = unpack_frame(
            jnp.asarray(packed), cfg.stereo.height, cfg.stereo.width,
            cc, cfg.stereo.invalid_value, precomputed_disp)
        disp, feats, cloud = self._compute_frame(
            left, right, color, disp_in=disp_in, color_stride=cc,
        )
        pose, used_vo, count, matches = tracking_step(
            feats, kf.features, kf.pose, kf.prior_pose, prior,
            self._key, frame_idx,
            cfg.matching, cfg.odometry,
        )
        return prior, pose, feats, cloud, used_vo, count, matches

    def _run_steady_step(self, packed, kf, fuse,
                         precomputed_disp: bool = False):
        """Sharded stages can't fuse into the single-dispatch steady step
        (the SGM slabs and BA shards are separate shard_map programs), so the
        distributed loop keeps the multi-stage structure."""
        from online_3d_reconstruction.runtime.pipeline import _fusion_stage

        prior, pose, feats, cloud, used_vo, count, matches = (
            self._sharded_frame(packed, kf, precomputed_disp))
        staging = self._staging
        if fuse:
            staging = _fusion_stage(staging, cloud, pose)
        return staging, pose, prior, feats, used_vo, count, matches

    def _run_steady_step_kf(self, packed, kf, fuse,
                            precomputed_disp: bool = False):
        """Keyframe event: sharded frame stages, then the device-window BA
        with the psum-sharded Schur solve; the map insert uses the refined
        pose, exactly like the single-chip fused variant."""
        from online_3d_reconstruction.ba.device_tracks import keyframe_step
        from online_3d_reconstruction.runtime.pipeline import _fusion_stage

        prior, pose, feats, cloud, used_vo, count, matches = (
            self._sharded_frame(packed, kf, precomputed_disp))
        ba_state, refined, _ = keyframe_step(
            self._ba_state, feats.points3d, feats.valid3d,
            matches.index, matches.valid, pose, prior,
            self.cfg.ba, self.mesh, noise_model=self._noise_model,
        )
        pose_ref = refined[ba_state.count - 1]
        staging = self._staging
        if fuse:
            staging = _fusion_stage(staging, cloud, pose_ref)
        return staging, pose_ref, prior, feats, used_vo, count, ba_state, refined

    def _compute_frame(self, left, right, color, disp_in=None,
                       color_stride: int = 1):
        cfg = self.cfg
        cs = max(int(color_stride), 1)
        if self._skip_rectify:
            left_r, right_r, color_r = left, right, color
        else:
            left_r, right_r = rectify_pair(left, right, self.map_left,
                                           self.map_right,
                                           band_left=self._bands[0],
                                           band_right=self._bands[1])
            if cs > 1:
                # color arrives pre-strided: remap on the strided grid with
                # source coords scaled into the subsampled plane
                color_map = self.map_left[::cs, ::cs] / float(cs)
                band_c = self._bands[2]
            else:
                color_map = self.map_left
                band_c = self._bands[0]
            if band_c > 0:
                color_r = remap_bilinear_banded(color, color_map, band_c)
            else:
                color_r = remap_bilinear(color, color_map)
        if disp_in is None:
            disp, valid = sharded_disparity(left_r, right_r, cfg.stereo,
                                            self.mesh, halo=self.sgm_halo)
        else:
            disp = disp_in
        feats = extract_frame_features(left_r, disp, self.q,
                                       cfg.features, cfg.odometry)
        cloud = backproject_disparity(
            disp, color_r, self.q,
            stride=cfg.mapping.frame_point_stride,
            min_depth=cfg.mapping.min_depth,
            max_depth=cfg.mapping.max_depth,
            invalid_value=cfg.stereo.invalid_value,
            color_prestrided=(cs > 1),
            color_substride=max(cs // cfg.mapping.frame_point_stride, 1),
        )
        return disp, feats, cloud

def reconstruct_distributed(dataset, config: PipelineConfig, rig: RectifiedRig,
                            mesh: Mesh, sgm_halo: int = 32) -> ReconstructionResult:
    """Multi-device `reconstruct`: same API, sharded stereo + BA stages."""
    engine = DistributedReconstructor(config, rig, mesh, sgm_halo=sgm_halo)
    for frame in dataset:
        engine.process(frame)
    return engine.finish()
