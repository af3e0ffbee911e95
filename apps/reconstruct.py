#!/usr/bin/env python
"""CLI driver for online 3D reconstruction — the reference's `pose` binary.

The reference's hand-rolled argv flags (frame range, voxel leaf size, pixel
stride "jump pixels", display/offline toggles — SURVEY.md §2.1 C1) map to:

  --first/--last        frame range
  --voxel-size          mapping.voxel_size
  --stride              mapping.frame_point_stride
  --disparity-dir       preprocessed-disparity mode (C2 offline option)
  --set sec.key=value   any config knob (replaces compiled-in constants)

plus dataset selection (synthetic oracle or an on-disk image-folder dataset
with a flight log), PLY/PCD/TUM outputs, JSONL metrics, checkpoint/resume,
and per-frame timing prints (C16).

Usage examples:
  python apps/reconstruct.py --synthetic 50 --output out/
  python apps/reconstruct.py --left data/left --right data/right \
      --flight-log data/log.csv --calib calib.json --output out/ --resume
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_argument_group("dataset")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="run N synthetic survey frames (the test oracle)")
    src.add_argument("--left", help="left image directory")
    src.add_argument("--right", help="right image directory")
    src.add_argument("--flight-log", help="flight log CSV (timestamp + pose)")
    src.add_argument("--disparity-dir", help="precomputed disparity .npy dir")
    src.add_argument("--calib", help="calibration JSON (see io/calibration.py); "
                     "with --synthetic, the raw views are rendered through it")
    src.add_argument("--first", type=int, default=0, help="first frame index")
    src.add_argument("--last", type=int, default=-1, help="last frame index (inclusive)")

    cfg = p.add_argument_group("config")
    cfg.add_argument("--config", help="YAML/JSON pipeline config file")
    cfg.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL",
                     help="config override, e.g. --set stereo.max_disparity=128")
    cfg.add_argument("--voxel-size", type=float, help="map voxel leaf size (m)")
    cfg.add_argument("--stride", type=int, help="pixel subsample stride")

    out = p.add_argument_group("output")
    out.add_argument("--output", default="out", help="output directory")
    out.add_argument("--ply", action="store_true", default=True, help="write map.ply")
    out.add_argument("--pcd", action="store_true", help="also write map.pcd")
    out.add_argument("--viewer", action="store_true",
                     help="write a standalone interactive viewer.html")
    out.add_argument("--viewer-every", type=int, default=0, metavar="K",
                     help="ALSO re-export viewer.html every K keyframes during "
                          "the run (live view via file refresh; the reference "
                          "shows the growing map in a PCLVisualizer window)")
    out.add_argument("--metrics", action="store_true", help="write metrics.jsonl")
    out.add_argument("--quiet", action="store_true", help="suppress per-frame prints")

    ckpt = p.add_argument_group("checkpointing")
    ckpt.add_argument("--checkpoint-every", type=int, default=0,
                      help="snapshot every N keyframes (0 = off)")
    ckpt.add_argument("--resume", action="store_true",
                      help="resume from <output>/checkpoints/snapshot.npz")
    return p.parse_args(argv)


def _parse_value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def _build_config(args):
    from online_3d_reconstruction.config import load_config

    # The measured-optimal estimator preset (BASELINE.md round-5 summary:
    # full-stack ATE 0.469x prior-only on the bench rig): whitened 3x3
    # stereo information with the MEASURED noise sigmas, a W=24 window with
    # landmark capacity scaled to the track count, 3 GN iterations (ATE-
    # identical to 5 at 60% of the cost). Applied only when no --config
    # file is given, and every entry yields to --set, so a rig with
    # different sensors retunes from the CLI or a file.
    overrides = {}
    if not args.config:
        overrides.update({
            "ba.obs_weighting": True,
            "ba.sigma_pixel": 0.5,
            "ba.sigma_disparity": 1.0,
            "ba.huber_delta": 3.0,
            "ba.window": 24,
            "ba.max_landmarks": 2048,
            "ba.gn_iters": 3,
        })
    for item in args.set:
        key, _, val = item.partition("=")
        if not val:
            raise SystemExit(f"--set expects SEC.KEY=VAL, got {item!r}")
        overrides[key] = _parse_value(val)
    if args.voxel_size is not None:
        overrides["mapping.voxel_size"] = args.voxel_size
    if args.stride is not None:
        overrides["mapping.frame_point_stride"] = args.stride
    if args.checkpoint_every:
        overrides["runtime.checkpoint_every"] = args.checkpoint_every
        overrides["runtime.checkpoint_dir"] = os.path.join(args.output, "checkpoints")
    if args.metrics:
        overrides["runtime.metrics_path"] = os.path.join(args.output, "metrics.jsonl")
    if args.disparity_dir:
        # offline mode (C5): consume precomputed maps instead of running SGM
        overrides.setdefault("runtime.use_precomputed_disparity", True)
    return load_config(args.config, overrides)


def _load_rig(args, cfg):
    """(rig, calibration or None): the rectified rig the pipeline runs on,
    and the raw calibration behind it when --calib gives one."""
    from online_3d_reconstruction.io.calibration import (
        identity_rig,
        load_calibration_json,
        stereo_rectify,
    )

    if args.calib:
        calib = load_calibration_json(args.calib)
        return stereo_rectify(calib), calib
    h, w = cfg.stereo.height, cfg.stereo.width
    return identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, baseline=0.5,
                        width=w, height=h), None


def _build_dataset(args, cfg, rig, calib):
    if args.synthetic:
        from online_3d_reconstruction.io.dataset import SyntheticSequence
        from online_3d_reconstruction.io.synthetic import (
            Plateau,
            SyntheticScene,
            make_survey_trajectory,
        )

        # supersample=2 integrates each pixel's footprint, as a real sensor
        # does (the bench's scene)
        scene = SyntheticScene(seed=5, plateaus=[Plateau(-6, 6, -4, 8, 8.0)],
                               supersample=2)
        poses = make_survey_trajectory(args.synthetic, altitude=30.0, speed=1.2)
        return SyntheticSequence(scene=scene, rig=rig, poses=poses, calib=calib)
    if not (args.left and args.right and args.flight_log):
        raise SystemExit("need --synthetic N, or --left/--right/--flight-log")
    from online_3d_reconstruction.io.dataset import ImageFolderSequence

    return ImageFolderSequence(
        left_dir=args.left, right_dir=args.right, flight_log=args.flight_log,
        disparity_dir=args.disparity_dir,
    )


def main(argv=None) -> int:
    args = _parse_args(argv)
    from online_3d_reconstruction.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(args.output, exist_ok=True)
    cfg = _build_config(args)
    rig, calib = _load_rig(args, cfg)
    dataset = _build_dataset(args, cfg, rig, calib)

    from online_3d_reconstruction.io.export import (
        save_pcd,
        save_ply,
        save_trajectory_tum,
    )
    from online_3d_reconstruction.runtime.pipeline import OnlineReconstructor

    engine = OnlineReconstructor(cfg, rig)
    start = 0
    snap = os.path.join(args.output, "checkpoints", "snapshot.npz")
    if args.resume and os.path.exists(snap):
        from online_3d_reconstruction.runtime.checkpoint import load_checkpoint

        load_checkpoint(engine, snap)
        start = engine.frame_idx
        print(f"resumed from {snap} at frame {start}", file=sys.stderr)

    viewer_path = os.path.join(args.output, "viewer.html")
    last = args.last if args.last >= 0 else len(dataset) - 1
    t0 = time.perf_counter()
    for i in range(max(args.first, start), last + 1):
        rec = engine.process(dataset[i])
        if (args.viewer_every and rec["keyframe"]
                and len(engine.keyframes) % args.viewer_every == 0):
            # live view (C14): re-export the growing map mid-run
            from online_3d_reconstruction.io.viewer import export_html

            pts, cols, traj = engine.snapshot_map()
            export_html(viewer_path, pts, cols, traj)
        if not args.quiet:
            stages = " ".join(
                f"{k[2:-3]}={v:.0f}ms" for k, v in rec.items() if k.startswith("t_")
            )
            print(
                f"frame {rec['frame']:5d} kf={int(rec['keyframe'])} "
                f"vo={int(rec['used_vo'])} inl={rec['vo_inliers']:4d} "
                f"map={rec['map_points']:8d} {stages}",
                file=sys.stderr,
            )
    result = engine.finish()
    elapsed = time.perf_counter() - t0

    if args.ply:
        save_ply(os.path.join(args.output, "map.ply"), result.map_points,
                 result.map_colors)
    if args.pcd:
        save_pcd(os.path.join(args.output, "map.pcd"), result.map_points,
                 result.map_colors)
    if args.viewer or args.viewer_every:
        from online_3d_reconstruction.io.viewer import export_html

        export_html(viewer_path, result.map_points,
                    result.map_colors, result.trajectory)
    save_trajectory_tum(os.path.join(args.output, "trajectory.tum"),
                        result.trajectory)
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump(result.metrics, f, indent=2)
    print(
        f"{result.metrics['frames']} frames in {elapsed:.1f}s "
        f"({result.metrics.get('frames_per_s', 0):.2f} fps), "
        f"{len(result.map_points)} map points, "
        f"{result.metrics['keyframes']} keyframes -> {args.output}/",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
