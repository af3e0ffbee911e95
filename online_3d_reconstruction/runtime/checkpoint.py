"""Checkpoint / resume for the online loop.

The reference has no resumable state — a crash loses the run (SURVEY.md §5).
Here a snapshot captures everything the online loop needs to continue at
frame i: the global map pool, trajectory so far, keyframe feature store,
BA track table, RNG key and frame cursor. Snapshots are atomic
(write-to-temp + rename) npz archives; device arrays round-trip through host
numpy. Multi-host runs snapshot per-process shards with the same API
(each process passes its own ``path``); orbax-style async checkpointing can
layer on top, but a survey-scale snapshot is tens of MB — synchronous write
is < 1 frame time.
"""

from __future__ import annotations

import os
import tempfile
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from online_3d_reconstruction.runtime.pipeline import OnlineReconstructor

_FORMAT_VERSION = 3  # v3: staging pool + device BA window


def save_checkpoint(engine: "OnlineReconstructor", path: str) -> None:
    """Snapshot the full reconstruction state to ``path`` (atomic)."""
    import jax

    from online_3d_reconstruction.runtime.pipeline import _Keyframe  # noqa: F401

    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "frame_idx": np.int64(engine.frame_idx),
        "host_cursor": np.int64(engine._host_cursor),
        "trajectory": np.asarray(engine.trajectory, dtype=np.float32).reshape(-1, 4, 4),
        "map_points": np.asarray(engine.gmap.points),
        "map_colors": np.asarray(engine.gmap.colors),
        "map_valid": np.asarray(engine.gmap.valid),
        "map_cursor": np.asarray(engine.gmap.cursor),
        "stg_points": np.asarray(engine._staging.points),
        "stg_colors": np.asarray(engine._staging.colors),
        "stg_valid": np.asarray(engine._staging.valid),
        "stg_cursor": np.asarray(engine._staging.cursor),
        "staged_points": np.int64(engine._staged_points),
        "rng_key": np.asarray(jax.random.key_data(engine._key)),
        "n_keyframes": np.int64(len(engine.keyframes)),
    }
    for i, kf in enumerate(engine.keyframes):
        payload[f"kf{i}_index"] = np.int64(kf.index)
        payload[f"kf{i}_pose"] = np.asarray(kf.pose)
        payload[f"kf{i}_prior"] = np.asarray(kf.prior_pose)
        payload[f"kf{i}_xy"] = np.asarray(kf.features.keypoints.xy)
        payload[f"kf{i}_score"] = np.asarray(kf.features.keypoints.score)
        payload[f"kf{i}_angle"] = np.asarray(kf.features.keypoints.angle)
        payload[f"kf{i}_desc"] = np.asarray(kf.features.keypoints.descriptors)
        payload[f"kf{i}_kpvalid"] = np.asarray(kf.features.keypoints.valid)
        payload[f"kf{i}_octave"] = np.asarray(kf.features.keypoints.octave)
        payload[f"kf{i}_pts3d"] = np.asarray(kf.features.points3d)
        payload[f"kf{i}_valid3d"] = np.asarray(kf.features.valid3d)
    if engine._ba is not None:
        payload["ba_next_lm"] = np.int64(engine._ba._next_lm)
        payload["ba_n_kf"] = np.int64(len(engine._ba.keyframes))
        for i, rec in enumerate(engine._ba.keyframes):
            payload[f"ba{i}_index"] = np.int64(rec.index)
            payload[f"ba{i}_pts"] = rec.points3d
            payload[f"ba{i}_valid"] = rec.valid3d
            payload[f"ba{i}_pose"] = rec.pose
            payload[f"ba{i}_lm"] = rec.lm_of_kp
    if engine._ba_state is not None:
        engine._flush_ba_events()  # refinements land in the saved trajectory
        payload["trajectory"] = np.asarray(
            engine.trajectory, dtype=np.float32
        ).reshape(-1, 4, 4)
        s = engine._ba_state
        for name in ("points3d", "valid3d", "match_idx", "match_ok",
                     "poses", "priors", "count"):
            payload[f"bawin_{name}"] = np.asarray(getattr(s, name))

    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(engine: "OnlineReconstructor", path: str) -> None:
    """Restore ``engine`` in place from a snapshot; resume at frame_idx."""
    import jax
    import jax.numpy as jnp

    from online_3d_reconstruction.ba.window import _KfRecord
    from online_3d_reconstruction.features.brief import Keypoints
    from online_3d_reconstruction.mapping.global_map import GlobalMap
    from online_3d_reconstruction.odometry.frontend import FrameFeatures
    from online_3d_reconstruction.runtime.pipeline import _Keyframe

    with np.load(path, allow_pickle=False) as z:
        version = int(z["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"checkpoint version {version} != {_FORMAT_VERSION}")
        engine.frame_idx = int(z["frame_idx"])
        engine._host_cursor = int(z["host_cursor"])
        engine.trajectory = [p for p in z["trajectory"]]
        engine.gmap = GlobalMap(
            points=jnp.asarray(z["map_points"]),
            colors=jnp.asarray(z["map_colors"]),
            valid=jnp.asarray(z["map_valid"]),
            cursor=jnp.asarray(z["map_cursor"]),
        )
        engine._key = jax.random.wrap_key_data(jnp.asarray(z["rng_key"]))
        engine._staging = GlobalMap(
            points=jnp.asarray(z["stg_points"]),
            colors=jnp.asarray(z["stg_colors"]),
            valid=jnp.asarray(z["stg_valid"]),
            cursor=jnp.asarray(z["stg_cursor"]),
        )
        engine._staged_points = int(z["staged_points"])
        engine.keyframes = []
        for i in range(int(z["n_keyframes"])):
            kp = Keypoints(
                xy=jnp.asarray(z[f"kf{i}_xy"]),
                score=jnp.asarray(z[f"kf{i}_score"]),
                angle=jnp.asarray(z[f"kf{i}_angle"]),
                descriptors=jnp.asarray(z[f"kf{i}_desc"]),
                valid=jnp.asarray(z[f"kf{i}_kpvalid"]),
                octave=jnp.asarray(z[f"kf{i}_octave"]),
            )
            feats = FrameFeatures(
                keypoints=kp,
                points3d=jnp.asarray(z[f"kf{i}_pts3d"]),
                valid3d=jnp.asarray(z[f"kf{i}_valid3d"]),
            )
            engine.keyframes.append(
                _Keyframe(
                    index=int(z[f"kf{i}_index"]),
                    features=feats,
                    pose=jnp.asarray(z[f"kf{i}_pose"]),
                    prior_pose=jnp.asarray(z[f"kf{i}_prior"]),
                )
            )
        if engine.keyframes:
            # the keyframe policy compares priors relative to the last keyframe
            engine._last_kf_prior = np.asarray(
                engine.keyframes[-1].prior_pose, dtype=np.float64
            )
        if engine._ba_state is not None and "bawin_poses" in z:
            from online_3d_reconstruction.ba.device_tracks import WindowState

            engine._ba_state = WindowState(
                points3d=jnp.asarray(z["bawin_points3d"]),
                valid3d=jnp.asarray(z["bawin_valid3d"]),
                match_idx=jnp.asarray(z["bawin_match_idx"]),
                match_ok=jnp.asarray(z["bawin_match_ok"]),
                poses=jnp.asarray(z["bawin_poses"]),
                priors=jnp.asarray(z["bawin_priors"]),
                count=jnp.asarray(z["bawin_count"]),
            )
            engine._ba_events = []
        if engine._ba is not None and "ba_n_kf" in z:
            engine._ba.keyframes = []
            engine._ba._next_lm = int(z["ba_next_lm"])
            for i in range(int(z["ba_n_kf"])):
                rec = _KfRecord(
                    index=int(z[f"ba{i}_index"]),
                    points3d=z[f"ba{i}_pts"],
                    valid3d=z[f"ba{i}_valid"],
                    pose=z[f"ba{i}_pose"],
                )
                rec.lm_of_kp = z[f"ba{i}_lm"].copy()
                engine._ba.keyframes.append(rec)
