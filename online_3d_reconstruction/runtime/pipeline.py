"""The online reconstruction loop — the reference's ``main()`` made a library.

Mirrors SURVEY.md §3.1 stage by stage: per frame — rectify, SGM disparity,
backproject, detect+describe, match vs previous keyframe, 3D-3D pose
correction composed with the flight-log prior, keyframe policy, cloud fusion
into the global voxel map, periodic downsampling, metrics. Local BA over the
keyframe window (§3.4) hooks in at keyframe events.

Structure: the heavy work is fused into three jitted stage
functions (frame compute / visual odometry / fusion) so each frame costs a
fixed, small number of dispatches; the host only composes 4x4 poses, decides
keyframes, and triggers the amortized map downsample. All device state
(global map pool, keyframe features) is static-shape.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.ba.device_tracks import (
    create_window,
    keyframe_core as ba_keyframe_core,
    keyframe_step as ba_keyframe_step,
)
from online_3d_reconstruction.ba.window import WindowBA
from online_3d_reconstruction.config import PipelineConfig
from online_3d_reconstruction.geometry import se3
from online_3d_reconstruction.geometry.backproject import PointCloud, backproject_disparity
from online_3d_reconstruction.io.calibration import RectifiedRig
from online_3d_reconstruction.io.dataset import FrameData
from online_3d_reconstruction.mapping.global_map import (
    GlobalMap,
    create_map,
    downsample_map,
    flush_staging,
    insert_cloud,
    map_to_numpy,
)
from online_3d_reconstruction.odometry.frontend import (
    FrameFeatures,
    extract_frame_features,
    tracking_step,
)
from online_3d_reconstruction.stereo.rectify import (
    rectify_pair,
    remap_bilinear,
    remap_bilinear_banded,
)
from online_3d_reconstruction.stereo.sgm import sgm_disparity
from online_3d_reconstruction.utils.metrics import MetricsLogger, StageTimer


class ReconstructionResult(NamedTuple):
    trajectory: np.ndarray        # (N, 4, 4) estimated world-from-camera
    keyframe_indices: np.ndarray  # (K,) frame index of each keyframe
    map_points: np.ndarray        # (M, 3)
    map_colors: np.ndarray        # (M, 3)
    metrics: dict                 # summary stats (frames/s, stage means, ...)


class _Keyframe(NamedTuple):
    index: int
    features: FrameFeatures
    pose: jnp.ndarray        # (4, 4) current world estimate (BA-refined)
    prior_pose: jnp.ndarray  # (4, 4) flight-log prior at that frame


@partial(jax.jit, static_argnames=("stereo_cfg", "feat_cfg", "odo_cfg", "map_cfg",
                                   "skip_rectify", "bands"))
def _frame_stage(left, right, color, map_left, map_right, q,
                 stereo_cfg, feat_cfg, odo_cfg, map_cfg, disp_in=None,
                 skip_rectify: bool = False, bands=(0, 0)):
    """Rectify -> disparity -> features -> camera-frame cloud (one dispatch).

    ``disp_in`` (optional (H, W) array) is a precomputed disparity map in the
    rectified-left frame — the reference's offline mode (SURVEY.md §2.1 C5
    "option to consume precomputed disparity images"): SGM is skipped and the
    supplied map feeds features + backprojection directly.

    ``skip_rectify`` (static): the rig's maps are the identity (already-
    rectified input, e.g. the synthetic oracle) — the remap would be a pure
    no-op. ``bands`` (static (left, right)): per-map vertical band heights
    for the matmul remap (stereo/rectify.remap_bilinear_banded); 0 = gather.
    """
    if skip_rectify:
        left_r, right_r = left, right
        color_r = left_r if color is None else color
    else:
        left_r, right_r = rectify_pair(left, right, map_left, map_right,
                                       band_left=bands[0], band_right=bands[1])
        if color is None:
            color_r = left_r
        elif bands[0] > 0:
            color_r = remap_bilinear_banded(color, map_left, bands[0])
        else:
            color_r = remap_bilinear(color, map_left)
    if disp_in is None:
        disp, valid = sgm_disparity(left_r, right_r, stereo_cfg)
    else:
        disp = disp_in
    feats = extract_frame_features(left_r, disp, q, feat_cfg, odo_cfg)
    cloud = backproject_disparity(
        disp, color_r, q,
        stride=map_cfg.frame_point_stride,
        min_depth=map_cfg.min_depth,
        max_depth=map_cfg.max_depth,
        invalid_value=stereo_cfg.invalid_value,
    )
    return disp, feats, cloud


@partial(jax.jit, donate_argnums=(0,))
def _fusion_stage(gmap: GlobalMap, cloud: PointCloud, pose: jnp.ndarray) -> GlobalMap:
    """Transform the camera-frame cloud to world and append to the map pool.

    The map pool is donated: the multi-MB point buffers update in place
    instead of being copied every frame.
    """
    world_pts = se3.transform_points(pose, cloud.points)
    return insert_cloud(gmap, PointCloud(world_pts, cloud.colors, cloud.valid))


_HEADER_FLOATS = 20      # prior pose (16) + frame index (1) + spare (3)
_HEADER_BYTES = 4 * _HEADER_FLOATS


def _color_grid(h: int, w: int, stride: int) -> Tuple[int, int]:
    return -(-h // stride), -(-w // stride)


def _color_stride(map_cfg) -> int:
    """Effective color-plane stride (MappingConfig.color_stride, 0 = the
    point stride); must be a multiple of frame_point_stride so each color
    texel serves a whole block of points."""
    cs = max(int(map_cfg.frame_point_stride), 1)
    cc = int(map_cfg.color_stride) or cs
    if cc % cs:
        raise ValueError(
            f"mapping.color_stride ({cc}) must be a multiple of "
            f"frame_point_stride ({cs})")
    return cc


def unpack_frame(packed, h: int, w: int, color_stride: int,
                 invalid_value: float, precomputed_disp: bool):
    """Device-side inverse of ``pack_frame``.

    The flat uint8 buffer carries: an 80-byte float32 header (prior pose +
    frame index — bitcast on device so the online loop never pays a separate
    small host->device transfer), full-resolution left/right gray planes,
    the color plane subsampled by ``color_stride`` (the cloud only samples
    color at the backprojection stride anyway), and optionally the 1/16-px
    fixed-point precomputed disparity. Returns (prior (4,4), frame_idx (), left, right,
    color_s (hs, ws, 3), disp | None).
    """
    header = jax.lax.bitcast_convert_type(
        packed[:_HEADER_BYTES].reshape(_HEADER_FLOATS, 4), jnp.float32)
    prior = header[:16].reshape(4, 4)
    frame_idx = header[16].astype(jnp.int32)

    hw = h * w
    off = _HEADER_BYTES
    scale = jnp.float32(1.0 / 255.0)
    left = packed[off:off + hw].reshape(h, w).astype(jnp.float32) * scale
    off += hw
    right = packed[off:off + hw].reshape(h, w).astype(jnp.float32) * scale
    off += hw
    hs, ws = _color_grid(h, w, color_stride)
    color = (packed[off:off + hs * ws * 3].reshape(hs, ws, 3)
             .astype(jnp.float32) * scale)
    off += hs * ws * 3
    disp = None
    if precomputed_disp:
        lo = packed[off:off + hw].reshape(h, w).astype(jnp.float32)
        hi = packed[off + hw:off + 2 * hw].reshape(h, w).astype(jnp.float32)
        raw = lo + 256.0 * hi
        disp = jnp.where(raw >= 65535.0, invalid_value, raw * (1.0 / 16.0))
    return prior, frame_idx, left, right, color, disp


def _packed_frame_body(packed, map_left, map_right, q,
                       stereo_cfg, feat_cfg, odo_cfg, map_cfg,
                       precomputed_disp: bool, skip_rectify: bool = False,
                       bands=(0, 0, 0)):
    """Shared device body: unpack -> rectify -> disparity -> features ->
    camera-frame cloud. ``precomputed_disp`` (static) selects the reference's
    offline mode (SURVEY.md C5): the packed buffer then carries the supplied
    rectified-left disparity as fixed-point planes and SGM is skipped
    entirely. ``skip_rectify``: identity maps (see _frame_stage). ``bands``
    (static (left, right, color)): banded-matmul remap band heights, 0 = gather.
    """
    cs = map_cfg.frame_point_stride
    cc = _color_stride(map_cfg)
    prior, frame_idx, left, right, color, disp = unpack_frame(
        packed, stereo_cfg.height, stereo_cfg.width, cc,
        stereo_cfg.invalid_value, precomputed_disp)

    if skip_rectify:
        left_r, right_r, color_r = left, right, color
    else:
        left_r, right_r = rectify_pair(left, right, map_left, map_right,
                                       band_left=bands[0], band_right=bands[1])
        # color travels at its own (coarser) stride: remap it on the strided
        # output grid, with source coords scaled into the subsampled plane
        color_map = map_left[::cc, ::cc] / float(cc)
        if bands[2] > 0:
            color_r = remap_bilinear_banded(color, color_map, bands[2])
        else:
            color_r = remap_bilinear(color, color_map)
    if not precomputed_disp:
        disp, _ = sgm_disparity(left_r, right_r, stereo_cfg)
    feats = extract_frame_features(left_r, disp, q, feat_cfg, odo_cfg)
    cloud = backproject_disparity(
        disp, color_r, q,
        stride=cs,
        min_depth=map_cfg.min_depth,
        max_depth=map_cfg.max_depth,
        invalid_value=stereo_cfg.invalid_value,
        color_prestrided=True,
        color_substride=cc // cs,
    )
    return prior, frame_idx, feats, cloud


@partial(jax.jit,
         static_argnames=("stereo_cfg", "feat_cfg", "odo_cfg", "map_cfg",
                          "match_cfg", "fuse", "precomputed_disp",
                          "skip_rectify", "bands"),
         donate_argnums=(0,))
def _steady_step(gmap, packed, map_left, map_right, q,
                 kf_feats, kf_pose, kf_prior, key,
                 stereo_cfg, feat_cfg, odo_cfg, map_cfg, match_cfg,
                 fuse: bool, precomputed_disp: bool = False,
                 skip_rectify: bool = False, bands=(0, 0, 0)):
    """The ENTIRE steady-state frame as one dispatch.

    Every dispatch and host->device transfer pays a fixed latency, so the
    loop ships exactly ONE flat uint8 buffer per frame —
    header (prior pose, frame index) + gray pair + strided color [+
    disparity] — and runs rectify -> SGM -> features -> backproject ->
    tracking -> fusion in a single XLA program. The unpacked prior is
    returned so keyframe bookkeeping never re-uploads it. Returns
    (gmap', pose, prior, feats, used_vo, inlier_count, matches).
    """
    prior, frame_idx, feats, cloud = _packed_frame_body(
        packed, map_left, map_right, q,
        stereo_cfg, feat_cfg, odo_cfg, map_cfg, precomputed_disp,
        skip_rectify, bands,
    )
    pose, used_vo, count, matches = tracking_step(
        feats, kf_feats, kf_pose, kf_prior, prior, key, frame_idx,
        match_cfg, odo_cfg,
    )
    if fuse:
        world_pts = se3.transform_points(pose, cloud.points)
        gmap = insert_cloud(gmap, PointCloud(world_pts, cloud.colors,
                                             cloud.valid))
    return gmap, pose, prior, feats, used_vo, count, matches


@partial(jax.jit,
         static_argnames=("stereo_cfg", "feat_cfg", "odo_cfg", "map_cfg",
                          "match_cfg", "ba_cfg", "fuse", "precomputed_disp",
                          "skip_rectify", "noise_model", "bands"),
         donate_argnums=(0, 1))
def _steady_step_kf(gmap, ba_state, packed, map_left, map_right, q,
                    kf_feats, kf_pose, kf_prior, key,
                    stereo_cfg, feat_cfg, odo_cfg, map_cfg, match_cfg,
                    ba_cfg, fuse: bool, precomputed_disp: bool = False,
                    skip_rectify: bool = False, noise_model=None,
                    bands=(0, 0, 0)):
    """Keyframe-event variant of ``_steady_step``: the window-BA append +
    track build + dense-Schur solve runs INSIDE the same dispatch, the map
    insert uses the BA-refined pose, and both the map pool and the BA window
    are donated. The keyframe decision itself is host-side (it reads only
    the flight-log priors), so the host picks which variant to dispatch.

    Returns (gmap', refined_pose, prior, feats, used_vo, count, ba_state',
    refined).
    """
    prior, frame_idx, feats, cloud = _packed_frame_body(
        packed, map_left, map_right, q,
        stereo_cfg, feat_cfg, odo_cfg, map_cfg, precomputed_disp,
        skip_rectify, bands,
    )
    pose, used_vo, count, matches = tracking_step(
        feats, kf_feats, kf_pose, kf_prior, prior, key, frame_idx,
        match_cfg, odo_cfg,
    )
    ba_state, refined, _ = ba_keyframe_core(
        ba_state, feats.points3d, feats.valid3d,
        matches.index, matches.valid, pose, prior, ba_cfg,
        noise_model=noise_model,
    )
    pose_ref = refined[ba_state.count - 1]
    if fuse:
        world_pts = se3.transform_points(pose_ref, cloud.points)
        gmap = insert_cloud(gmap, PointCloud(world_pts, cloud.colors,
                                             cloud.valid))
    return gmap, pose_ref, prior, feats, used_vo, count, ba_state, refined


def pack_frame(frame: FrameData, use_disparity: bool = False,
               color_stride: int = 1, frame_index: int = 0) -> np.ndarray:
    """Host-side packing of one frame into ONE flat uint8 upload buffer.

    Layout (see ``unpack_frame``): 80-byte float32 header (prior pose +
    frame index) | left gray | right gray | color subsampled by
    ``color_stride`` [| disparity lo | hi byte planes].

    uint8 is deliberate: it is exactly what a real camera delivers, and a
    quarter of the upload bytes of float32. The header rides in the same
    buffer so that no separate small synced upload is paid. Color travels
    at the backprojection stride (the only consumer).
    The optional precomputed disparity (offline mode) travels as 1/16-px
    uint16 fixed point split into lo/hi byte planes (sentinel 0xFFFF =
    invalid), matching cv2's 4-fraction-bit convention.
    """
    def q8(x):
        return np.clip(x * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)

    header = np.zeros(_HEADER_FLOATS, dtype=np.float32)
    header[:16] = np.asarray(frame.prior_pose, dtype=np.float32).ravel()
    header[16] = float(frame_index)
    cs = max(int(color_stride), 1)
    parts = [header.view(np.uint8), q8(frame.left).ravel(),
             q8(frame.right).ravel(),
             np.ascontiguousarray(q8(frame.color)[::cs, ::cs]).ravel()]
    if use_disparity:
        d = np.asarray(frame.disparity, dtype=np.float32)
        fixed = np.where(d >= 0.0, np.clip(np.round(d * 16.0), 0, 65534),
                         65535).astype(np.uint16)
        parts.append((fixed & 0xFF).astype(np.uint8).ravel())
        parts.append((fixed >> 8).astype(np.uint8).ravel())
    return np.concatenate(parts)


class OnlineReconstructor:
    """Streaming driver: feed ``FrameData``, read back trajectory + map."""

    def __init__(self, config: PipelineConfig, rig: RectifiedRig):
        self.cfg = config
        self.rig = rig
        if config.runtime.debug_nans:
            # the functional-model "sanitizer" (SURVEY.md §5): trap NaNs at
            # the op that produced them instead of reading garbage poses
            jax.config.update("jax_debug_nans", True)
        self.q = jnp.asarray(rig.q, dtype=jnp.float32)
        self.map_left = jnp.asarray(rig.map_left)
        self.map_right = jnp.asarray(rig.map_right)
        # already-rectified input (identity maps, e.g. the synthetic oracle
        # or a pre-rectified dataset): skip the remap gather (~8 ms/frame)
        mh, mw = np.asarray(rig.map_left).shape[:2]
        gx, gy = np.meshgrid(np.arange(mw, dtype=np.float32),
                             np.arange(mh, dtype=np.float32))
        ident = np.stack([gx, gy], axis=-1)
        self._skip_rectify = bool(
            np.array_equal(np.asarray(rig.map_left), ident)
            and np.array_equal(np.asarray(rig.map_right), ident)
        )
        # static band heights for the matmul remap (stereo/rectify); a
        # degenerate map with a huge band falls back to the gather form
        self._bands = (0, 0, 0)
        if not self._skip_rectify:
            from online_3d_reconstruction.stereo.rectify import vertical_band

            cc = _color_stride(config.mapping)
            bl = vertical_band(np.asarray(rig.map_left))
            br = vertical_band(np.asarray(rig.map_right))
            bc = vertical_band(np.asarray(rig.map_left)[::cc, ::cc] / cc)
            cap = mh // 4
            self._bands = tuple(b if b <= cap else 0 for b in (bl, br, bc))
        self.gmap = create_map(config.mapping.map_capacity)
        self._capacity = config.mapping.map_capacity
        s = config.mapping.frame_point_stride
        self._frame_points = (
            -(-config.stereo.height // s) * -(-config.stereo.width // s)
        )
        # two-level map: frames land in a staging pool sized for one flush
        # interval, so the frequent voxel sort never touches the full pool
        flush_frames = max(config.mapping.downsample_every, 1)
        self._staging_cap = min(self._capacity,
                                flush_frames * self._frame_points)
        self._staging = create_map(self._staging_cap)
        self._staged_points = 0
        self._host_cursor = 0
        self._last_kf_prior = np.eye(4)
        self._pending_vo: List = []   # deferred (frame, used_vo, count) scalars
        self.trajectory: List = []    # device or host (4,4) poses
        self.keyframes: List[_Keyframe] = []
        self.frame_idx = 0
        self._frames_since_fuse = 0
        self._key = jax.random.PRNGKey(config.odometry.seed)
        self.metrics = MetricsLogger(config.runtime.metrics_path)
        # BA backends: the on-device window (default — one dispatch per
        # keyframe, zero host syncs) or the host track-table (host_ba=True,
        # also used by the observation-sharded distributed solver)
        self._ba = None
        self._ba_state = None
        self._ba_events: List = []   # (kf_indices, refined (W,4,4) handle)
        # the full 3x3 observation information needs the rig's stereo
        # geometry (ba.problem.StereoNoiseModel is static/hashable so it can
        # ride through the jitted keyframe dispatch)
        self._noise_model = None
        if config.ba.obs_weighting and rig.fx > 0 and rig.baseline > 0:
            from online_3d_reconstruction.ba.problem import StereoNoiseModel

            self._noise_model = StereoNoiseModel(
                fx=float(rig.fx), fy=float(rig.fy),
                baseline=float(rig.baseline),
                sigma_px=float(config.ba.sigma_pixel),
                sigma_disparity=float(config.ba.sigma_disparity),
            )
        if config.runtime.ba_every_keyframe:
            if config.runtime.host_ba:
                self._ba = WindowBA(config.ba, noise_model=self._noise_model)
            else:
                self._ba_state = create_window(
                    config.ba.window, config.features.max_keypoints
                )
                k = config.features.max_keypoints
                self._no_match = (jnp.zeros((k,), jnp.int32),
                                  jnp.zeros((k,), bool))
        self._t_start = None

    # -- keyframe policy (reference: new keyframe on sufficient motion) -----
    def _is_keyframe(self, prior_np: np.ndarray) -> bool:
        """Decide from the host-side flight-log priors.

        Using the estimated pose would force a device sync every frame just
        for this bool; the prior's *relative* motion since the last keyframe
        is equally good for a motion-threshold policy and is already on host.
        """
        if not self.keyframes:
            return True
        if self.frame_idx - self.keyframes[-1].index < self.cfg.runtime.keyframe_min_gap:
            return False
        rel = np.linalg.inv(self._last_kf_prior) @ prior_np
        t_err = float(np.linalg.norm(rel[:3, 3]))
        cos_t = np.clip((np.trace(rel[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        r_err = float(np.arccos(cos_t))
        return (
            t_err > self.cfg.runtime.keyframe_translation
            or r_err > self.cfg.runtime.keyframe_rotation
        )

    def _use_disparity(self, frame: FrameData) -> bool:
        """Offline mode (C5): opt-in via config AND the frame must carry one."""
        return (self.cfg.runtime.use_precomputed_disparity
                and frame.disparity is not None)

    def _compute_frame(self, left, right, color, disp_in=None):
        """The per-frame device stage; DistributedReconstructor overrides
        this with the mesh-sharded variant."""
        cfg = self.cfg
        return _frame_stage(
            left, right, color, self.map_left, self.map_right, self.q,
            cfg.stereo, cfg.features, cfg.odometry, cfg.mapping,
            disp_in=disp_in, skip_rectify=self._skip_rectify,
            bands=self._bands[:2],
        )

    def pack(self, frame: FrameData, frame_index: "int | None" = None
             ) -> np.ndarray:
        """Pack a frame for this engine's config (prefetchers call this to
        move the pack + upload off the critical path; see ``process``)."""
        return pack_frame(
            frame, self._use_disparity(frame),
            color_stride=_color_stride(self.cfg.mapping),
            frame_index=self.frame_idx if frame_index is None else frame_index,
        )

    def _run_steady_step(self, packed, kf: "_Keyframe", fuse: bool,
                         precomputed_disp: bool = False):
        """One fused device dispatch for a steady-state frame; the
        DistributedReconstructor overrides this with its sharded stages."""
        cfg = self.cfg
        return _steady_step(
            self._staging, jnp.asarray(packed),
            self.map_left, self.map_right, self.q,
            kf.features, kf.pose, kf.prior_pose, self._key,
            cfg.stereo, cfg.features, cfg.odometry, cfg.mapping,
            cfg.matching, fuse, precomputed_disp, self._skip_rectify,
            self._bands,
        )

    def _run_steady_step_kf(self, packed, kf: "_Keyframe", fuse: bool,
                            precomputed_disp: bool = False):
        """Keyframe-event dispatch: steady step + window BA fused."""
        cfg = self.cfg
        return _steady_step_kf(
            self._staging, self._ba_state, jnp.asarray(packed),
            self.map_left, self.map_right, self.q,
            kf.features, kf.pose, kf.prior_pose, self._key,
            cfg.stereo, cfg.features, cfg.odometry, cfg.mapping,
            cfg.matching, cfg.ba, fuse, precomputed_disp,
            self._skip_rectify, self._noise_model, self._bands,
        )

    def process(self, frame: FrameData, packed=None) -> dict:
        """Run one frame through the full pipeline; returns frame metrics.

        ``packed`` optionally supplies the ``engine.pack(frame)`` buffer —
        possibly already device-resident — letting a prefetcher (or bench
        attribution run) move the host packing + upload off the critical path.
        """
        if self._t_start is None:
            self._t_start = time.perf_counter()
        timer = StageTimer()
        cfg = self.cfg

        used_vo: object = False
        inliers: object = 0
        matches = None
        refined = None
        fused = False
        fuse = self._frames_since_fuse + 1 >= cfg.mapping.fuse_every
        use_disp = self._use_disparity(frame)
        if not self.keyframes:
            # first frame: anchor the world to the prior (no tracking target)
            prior = jnp.asarray(frame.prior_pose, dtype=jnp.float32)
            with timer.stage("frame_compute"):
                disp, feats, cloud = self._compute_frame(
                    jnp.asarray(frame.left), jnp.asarray(frame.right),
                    jnp.asarray(frame.color),
                    disp_in=(jnp.asarray(frame.disparity) if use_disp
                             else None),
                )
            pose = prior
            if fuse:
                with timer.stage("fusion"):
                    self._staging = _fusion_stage(self._staging, cloud, pose)
                fused = True
        else:
            kf = self.keyframes[-1]
            # the keyframe policy reads only host-side priors, so the host
            # knows before dispatching whether this frame's BA runs — and can
            # pick the variant that fuses the BA solve into the same dispatch
            is_kf = self._is_keyframe(frame.prior_pose)
            fuse_ba = is_kf and self._ba_state is not None
            with timer.stage("step"):
                if packed is None:
                    packed = self.pack(frame)
                if fuse_ba:
                    (self._staging, pose, prior, feats, used_vo_j, count,
                     self._ba_state, refined) = self._run_steady_step_kf(
                        packed, kf, fuse, use_disp)
                    matches = None  # consumed in-dispatch by the BA append
                else:
                    (self._staging, pose, prior, feats, used_vo_j, count,
                     matches) = self._run_steady_step(packed, kf, fuse,
                                                      use_disp)
                fused = fuse
                if cfg.runtime.sync_metrics:
                    used_vo = bool(used_vo_j)   # forces a device sync
                    inliers = int(count)
                else:
                    self._pending_vo.append((self.frame_idx, used_vo_j, count))
                    used_vo, inliers = None, None

        self.trajectory.append(pose)  # device array; fetched in bulk at finish

        is_kf = self._is_keyframe(frame.prior_pose)
        if is_kf:
            self._last_kf_prior = np.asarray(frame.prior_pose, dtype=np.float64)
            self.keyframes.append(
                _Keyframe(index=self.frame_idx, features=feats, pose=pose,
                          prior_pose=prior)
            )
            if self._ba_state is not None:
                with timer.stage("ba"):
                    if refined is None:
                        # first keyframe: nothing fused yet — standalone append
                        m_idx, m_ok = (
                            (matches.index, matches.valid)
                            if matches is not None else self._no_match
                        )
                        self._ba_state, refined, _ = ba_keyframe_step(
                            self._ba_state, feats.points3d, feats.valid3d,
                            m_idx, m_ok, pose, prior, self.cfg.ba,
                            noise_model=self._noise_model,
                        )
                        live = min(len(self.keyframes), self.cfg.ba.window)
                        # the newest slot's refined pose seeds the next
                        # tracking step (fused variant returns it directly)
                        self.keyframes[-1] = self.keyframes[-1]._replace(
                            pose=refined[live - 1]
                        )
                    else:
                        live = min(len(self.keyframes), self.cfg.ba.window)
                    # trajectory entries are patched in bulk at finish()
                    self._ba_events.append(
                        ([k.index for k in self.keyframes[-live:]], refined)
                    )
            elif self._ba is not None:
                with timer.stage("ba"):
                    # one bulk device->host pull for the track bookkeeping
                    pts_np, v3d_np, pose_np, m_idx, m_ok = jax.device_get(
                        (feats.points3d, feats.valid3d, pose,
                         matches.index if matches is not None else (),
                         matches.valid if matches is not None else ())
                    )
                    self._ba.add_keyframe(
                        index=self.frame_idx,
                        points3d=pts_np,
                        valid3d=v3d_np,
                        pose=pose_np,
                        match_index=m_idx if matches is not None else None,
                        match_valid=m_ok if matches is not None else None,
                    )
                    self._run_window_ba()

        with timer.stage("fusion"):
            self._frames_since_fuse += 1
            if fused:
                self._frames_since_fuse = 0
                self._staged_points += self._frame_points  # upper bound
            periodic = (
                cfg.mapping.downsample_every > 0
                and (self.frame_idx + 1) % cfg.mapping.downsample_every == 0
            )
            if self._staged_points and (
                periodic
                or self._staged_points + self._frame_points > self._staging_cap
            ):
                # voxelize the staging pool and merge into the main pool
                self.gmap, self._staging = flush_staging(
                    self.gmap, self._staging,
                    cfg.mapping.voxel_size, cfg.mapping.bounds,
                )
                self._host_cursor += self._staged_points  # survivor bound
                self._staged_points = 0
                if self._host_cursor + self._staging_cap >= self._capacity:
                    # rare: re-voxelize the whole main pool near capacity
                    self.gmap = downsample_map(
                        self.gmap, cfg.mapping.voxel_size, cfg.mapping.bounds
                    )
                    self._host_cursor = int(self.gmap.cursor)  # one sync

        if (
            cfg.runtime.checkpoint_every > 0
            and is_kf
            and len(self.keyframes) % cfg.runtime.checkpoint_every == 0
        ):
            from online_3d_reconstruction.runtime.checkpoint import save_checkpoint

            with timer.stage("checkpoint"):
                save_checkpoint(
                    self, os.path.join(cfg.runtime.checkpoint_dir, "snapshot.npz")
                )

        record = {
            "frame": self.frame_idx,
            "keyframe": is_kf,
            "map_points": self._host_cursor,
            **{f"t_{k}_ms": v * 1e3 for k, v in timer.times.items()},
        }
        if used_vo is not None:
            record["used_vo"] = used_vo
            record["vo_inliers"] = inliers
        self.metrics.log(record)
        self.frame_idx += 1
        return record

    def _flush_ba_events(self) -> None:
        """Apply deferred device-BA refinements to the trajectory: one bulk
        pull, then each keyframe entry gets the newest estimate that saw it."""
        if not self._ba_events:
            return
        refined_all = jax.device_get([r for _, r in self._ba_events])
        for (kf_indices, _), ref in zip(self._ba_events, refined_all):
            for slot, idx in enumerate(kf_indices):
                if idx < len(self.trajectory):
                    self.trajectory[idx] = ref[slot]
        self._ba_events = []

    def _run_window_ba(self) -> None:
        """Refine the sliding keyframe window and sync pipeline state."""
        refined = self._ba.solve_window()
        if refined is None:
            return
        for i, pose in enumerate(refined):
            k = len(self.keyframes) - len(refined) + i
            self.keyframes[k] = self.keyframes[k]._replace(
                pose=jnp.asarray(pose)
            )
        # keep the public trajectory consistent with the refined keyframes
        for kf in self.keyframes[-len(refined):]:
            if kf.index < len(self.trajectory):
                self.trajectory[kf.index] = np.asarray(kf.pose)

    def snapshot_map(self):
        """Fetch the CURRENT fused map (main pool + staged frames) and
        trajectory for live visualization (SURVEY.md §2.1 C14) — one bulk
        device_get, opt-in and periodic; the steady-state loop itself stays
        sync-free. Returns (points (N,3), colors (N,3), trajectory (K,4,4))."""
        pts, cols = map_to_numpy(self.gmap)
        spts, scols = map_to_numpy(self._staging)
        traj = (np.stack(jax.device_get(list(self.trajectory)))
                if self.trajectory else np.zeros((0, 4, 4), np.float32))
        return (np.concatenate([pts, spts]), np.concatenate([cols, scols]),
                traj)

    def finish(self, warmup_frames=None) -> ReconstructionResult:
        """Flush the map and return trajectory + fused cloud + metrics.

        ``warmup_frames`` frames are excluded from the metric summary's stage
        means (they contain jit compiles; see MetricsLogger.summary). The
        default (None) auto-detects them from stage-time outliers, so plain
        ``reconstruct()`` users get steady-state summaries too.
        """
        jax.block_until_ready(self.gmap.points)
        elapsed = (time.perf_counter() - self._t_start) if self._t_start else 0.0
        if self._staged_points:
            self.gmap, self._staging = flush_staging(
                self.gmap, self._staging,
                self.cfg.mapping.voxel_size, self.cfg.mapping.bounds,
            )
            self._staged_points = 0
        self.gmap = downsample_map(
            self.gmap, self.cfg.mapping.voxel_size, self.cfg.mapping.bounds
        )
        pts, cols = map_to_numpy(self.gmap)
        if self._pending_vo:
            # deferred VO scalars: one bulk transfer, patch the frame records
            vals = jax.device_get([(u, c) for _, u, c in self._pending_vo])
            for (idx, _, _), (u, c) in zip(self._pending_vo, vals):
                if idx < len(self.metrics.records):
                    self.metrics.records[idx]["used_vo"] = bool(u)
                    self.metrics.records[idx]["vo_inliers"] = int(c)
            self._pending_vo = []
        self._flush_ba_events()
        if warmup_frames is None:
            warmup_frames = self.metrics.auto_warmup()
        summary = self.metrics.summary(skip_first=warmup_frames)
        summary["warmup_frames_excluded"] = warmup_frames
        summary["frames"] = self.frame_idx
        summary["keyframes"] = len(self.keyframes)
        if elapsed > 0:
            summary["frames_per_s"] = self.frame_idx / elapsed
        self.metrics.close()
        return ReconstructionResult(
            trajectory=np.stack([np.asarray(p) for p in self.trajectory])
            if self.trajectory else np.zeros((0, 4, 4), np.float32),
            keyframe_indices=np.asarray([k.index for k in self.keyframes]),
            map_points=pts,
            map_colors=cols,
            metrics=summary,
        )


def reconstruct(dataset, config: PipelineConfig, rig: RectifiedRig) -> ReconstructionResult:
    """One-call API: iterate a dataset through the online loop.

    The L7 entry point (SURVEY.md §3.6): ``o3r.reconstruct(dataset, config)``.
    Host ingest, frame packing, AND the host->device upload are all
    prefetched ``runtime.prefetch_depth`` frames ahead in a worker thread
    (P5) so the steady-state loop consumes device-resident buffers; the run
    is optionally wrapped in a jax.profiler trace.
    """
    from online_3d_reconstruction.runtime.prefetch import device_prefetch

    engine = OnlineReconstructor(config, rig)
    trace_dir = None
    if config.runtime.profile:
        trace_dir = os.path.join(config.runtime.checkpoint_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        jax.profiler.start_trace(trace_dir)
    try:
        for frame, packed in device_prefetch(dataset, engine,
                                             config.runtime.prefetch_depth):
            engine.process(frame, packed=packed)
    finally:
        if trace_dir is not None:
            jax.profiler.stop_trace()
    return engine.finish()
