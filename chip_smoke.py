#!/usr/bin/env python3
"""Smoke test: the online reconstruction loop on one CUDA GPU, end to end.

    python3 chip_smoke.py              # phases 1-5, one GPU
    python3 chip_smoke.py --four-gpus  # phase 6 only: the sharded paths, 4 GPUs

Phases, all in this one process (a second JAX process could not get the
card's memory):

1. device: JAX sees a GPU; the card's name and power limit are printed.
2. the CUDA SGM aggregation kernel against ``aggregate_scan`` (its plain
   reference) on the card: 384x512xD64 with 2, 4 and 8 paths (float32 within
   1e-3; bfloat16 storage WTA mismatch < 0.5%), and one KITTI-shaped
   376x1241xD128 bfloat16 volume (odd width, four disparities per lane).
3. the whole disparity stage (``sgm_disparity``) on the synthetic scene at
   512x384, D64, 8 paths: valid density > 0.9, bad>1px < 0.02.
4. the same window bundle adjustment (W=64, L=2048, 512 obs/frame) on the
   CPU and on the GPU: refined poses agree within 1e-4 m and 1e-4 rad.
5. the main path: ``apps/reconstruct.py``'s ``main`` on 32 synthetic frames
   with the bench's distorted rig and configuration; the trajectory is
   finite, full-stack ATE beats prior-only, the map is non-empty. Then the
   steady-state frame period with the kernel and with ``aggregate_scan``.
6. (``--four-gpus`` only) row-slab SGM, slot-sharded BA, owner-routed voxel
   merge and the distributed loop against their one-device forms, with
   every sharded output spanning the 4 devices.

Each phase line carries the card's name and power limit. The last line of
stdout is one JSON object, ``{"ok": true, "device": {...}}``, printed only
if every phase passed; where JAX finds no GPU the script prints no result
and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

CARD = ""   # "<name>, <power limit>" from nvidia-smi, set by main()


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def render_frames(dataset, n: int):
    """The first ``n`` frames of a synthetic sequence, rendered on host
    threads (numpy releases the GIL for most of a render; the frames are
    the same as a sequential render's)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as pool:
        return list(pool.map(dataset.__getitem__, range(n)))


def census_costs(shape, seed):
    """Random integer costs in the 5x5 census range [0, 24]."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 25, shape).astype(np.float32))


def scan_reference(cost, num_paths, dtype):
    import jax

    from online_3d_reconstruction.stereo.sgm import aggregate_scan

    with jax.default_matmul_precision("highest"):
        fn = jax.jit(lambda c: aggregate_scan(c, 8.0, 32.0, num_paths, dtype))
        return fn, np.asarray(fn(cost))


def phase_kernel() -> None:
    import jax
    import jax.numpy as jnp

    from online_3d_reconstruction.stereo.sgm_cuda import aggregate_cuda
    from online_3d_reconstruction.utils.roofline import measure

    def kernel(num_paths, dtype):
        return jax.jit(lambda c: aggregate_cuda(c, 8.0, 32.0, num_paths, dtype))

    cost = census_costs((384, 512, 64), 0)
    for num_paths in (2, 4, 8):
        ref_fn, ref = scan_reference(cost, num_paths, jnp.float32)
        k32, k16 = kernel(num_paths, jnp.float32), kernel(num_paths, jnp.bfloat16)
        diff = float(np.abs(np.asarray(k32(cost)) - ref).max())
        mismatch = float((np.asarray(k16(cost)).argmin(-1) != ref.argmin(-1)).mean())
        assert diff <= 1e-3, f"{num_paths} paths: f32 max |diff| {diff}"
        assert mismatch < 0.005, f"{num_paths} paths: bf16 WTA mismatch {mismatch}"
        log(f"phase 2 ok: 384x512xD64 {num_paths} paths: f32 max|diff| {diff}, "
            f"bf16 WTA mismatch {mismatch}; per call: kernel f32 "
            f"{measure(k32, (cost,)) * 1e3:.4f} ms, bf16 "
            f"{measure(k16, (cost,)) * 1e3:.4f} ms, aggregate_scan f32 "
            f"{measure(ref_fn, (cost,), n=3) * 1e3:.3f} ms")

    # KITTI-shaped: an odd width and D=128 (four disparities per lane)
    cost = census_costs((376, 1241, 128), 1)
    ref16_fn, ref16 = scan_reference(cost, 8, jnp.bfloat16)
    _, ref32 = scan_reference(cost, 8, jnp.float32)
    k16 = kernel(8, jnp.bfloat16)
    got = np.asarray(k16(cost))
    diff = float(np.abs(got - ref16).max())
    mismatch = float((got.argmin(-1) != ref32.argmin(-1)).mean())
    assert diff <= 1e-3, f"KITTI shape: max |diff| to the bf16 reference {diff}"
    assert mismatch < 0.005, f"KITTI shape: WTA mismatch {mismatch}"
    log(f"phase 2 ok: 376x1241xD128 8 paths bf16: max|diff| {diff} to the bf16 "
        f"reference, WTA mismatch {mismatch} to f32; per call: kernel "
        f"{measure(k16, (cost,)) * 1e3:.4f} ms, aggregate_scan "
        f"{measure(ref16_fn, (cost,), n=3) * 1e3:.3f} ms")


def phase_disparity() -> None:
    import jax
    import jax.numpy as jnp

    from online_3d_reconstruction.config import StereoConfig
    from online_3d_reconstruction.io.calibration import identity_rig
    from online_3d_reconstruction.io.synthetic import SyntheticScene, nadir_pose
    from online_3d_reconstruction.stereo.sgm import sgm_disparity, speckle_filter
    from online_3d_reconstruction.utils.roofline import measure

    h, w = 384, 512
    rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, baseline=0.5,
                       width=w, height=h)
    frame = SyntheticScene(seed=3).render_stereo(nadir_pose(0.0, 0.0, 30.0), rig)
    left, right = jnp.asarray(frame.left), jnp.asarray(frame.right)
    times = {}
    for agg in ("cuda", "scan"):
        cfg = StereoConfig(height=h, width=w, max_disparity=64, num_paths=8,
                           aggregation=agg)
        times[agg] = measure(lambda a, b: sgm_disparity(a, b, cfg),
                             (left, right))
        if agg == "cuda":
            disp, valid = (np.asarray(x) for x in sgm_disparity(left, right, cfg))
    gt = frame.gt_disparity
    ok = valid & (gt > 0)
    density = float(ok.mean())
    bad = float((np.abs(disp[ok] - gt[ok]) > 1.0).mean())
    assert density > 0.9, f"valid density {density}"
    assert bad < 0.02, f"bad>1px {bad}"
    # the speckle filter alone (XLA's form; a fixed amount of work per frame)
    speckle = jax.jit(lambda d, v: speckle_filter(d, v, cfg.speckle_window,
                                                  cfg.speckle_range))
    t_speckle = measure(speckle, (jnp.asarray(disp), jnp.asarray(valid)))
    log(f"phase 3 ok: sgm_disparity 512x384 D64 8 paths: valid density "
        f"{density:.4f}, bad>1px {bad:.5f}; per frame: with the kernel "
        f"{times['cuda'] * 1e3:.3f} ms, with aggregate_scan "
        f"{times['scan'] * 1e3:.3f} ms; speckle_filter alone "
        f"{t_speckle * 1e3:.3f} ms")


def pose_differences(a, b):
    """Max translation (m) and rotation angle (rad) between pose stacks."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    dt = float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())
    rel = np.einsum("nji,njk->nik", a[:, :3, :3], b[:, :3, :3])
    skew = rel - np.transpose(rel, (0, 2, 1))
    dr = float((np.linalg.norm(skew, axis=(1, 2)) / 2.0 ** 1.5).max())
    return dt, dr


def ba_problem(w=64, l=2048, k=512):
    from online_3d_reconstruction.ba.testing import make_synthetic_bundle

    problem, _, _ = make_synthetic_bundle(np.random.default_rng(2), w=w, l=l,
                                          obs_noise=0.02, n_cap=w * k,
                                          obs_per_kf=k)
    return problem


def phase_cpu_vs_gpu() -> None:
    import functools

    import jax

    from online_3d_reconstruction.ba.schur import solve_ba

    problem = ba_problem()
    solve = jax.jit(functools.partial(solve_ba, iters=5, damping=1e-4,
                                      huber_delta=0.5, slot_major=512))
    cpu, gpu = jax.devices("cpu")[0], jax.devices()[0]
    p_cpu = np.asarray(solve(jax.device_put(problem, cpu))[0])
    p_gpu = np.asarray(solve(jax.device_put(problem, gpu))[0])
    dt, dr = pose_differences(p_cpu, p_gpu)
    # Why 1e-4: both runs are float32 Gauss-Newton on poses of O(10 m); the
    # two backends sum in other orders, which moves a pose by ~1e-6 m, and
    # five well-conditioned steps do not amplify that past ~1e-5. Products
    # in TF32 (10-bit mantissa) instead of float32 would move poses by
    # ~1e-3: 1e-4 m and 1e-4 rad separate reordering from lost precision.
    assert dt <= 1e-4 and dr <= 1e-4, f"CPU vs GPU poses: {dt} m, {dr} rad"
    log(f"phase 4 ok: solve_ba W=64 L=2048 512 obs/frame, CPU vs GPU: max "
        f"translation {dt:.3e} m, max rotation {dr:.3e} rad")


def write_bench_inputs(directory):
    """The bench's rig, scene and configuration as the files the CLI reads:
    (calibration JSON, config JSON, dataset, rig, config, warmup, timed)."""
    import bench
    from online_3d_reconstruction.config import config_to_dict

    _, rig, dataset, cfg, n_warmup, n_timed = bench._make_bench_setup()
    cam = dataset.calib.left
    intrinsics = {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy,
                  "width": cam.width, "height": cam.height,
                  "dist": list(cam.dist)}
    calib_path = os.path.join(directory, "calib.json")
    with open(calib_path, "w") as f:
        json.dump({"left": intrinsics, "right": intrinsics,
                   "translation": np.asarray(dataset.calib.translation).tolist()},
                  f)
    config_path = os.path.join(directory, "config.json")
    with open(config_path, "w") as f:
        json.dump(config_to_dict(cfg), f)
    return calib_path, config_path, dataset, rig, cfg, n_warmup, n_timed


def phase_main_path() -> None:
    import dataclasses

    import bench
    from apps.reconstruct import main as reconstruct_main
    from online_3d_reconstruction.io.export import load_ply, load_trajectory_tum
    from online_3d_reconstruction.io.synthetic import (
        make_survey_trajectory,
        perturb_poses,
    )
    from online_3d_reconstruction.utils.metrics import ate_rmse

    n_frames = 32
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        calib, config, dataset, rig, cfg, n_warmup, n_timed = write_bench_inputs(tmp)
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        rc = reconstruct_main(["--synthetic", str(n_frames), "--calib", calib,
                               "--config", config, "--output", out, "--quiet"])
        wall = time.perf_counter() - t0
        assert rc == 0, f"apps/reconstruct.py returned {rc}"
        _, traj = load_trajectory_tum(os.path.join(out, "trajectory.tum"))
        points, _ = load_ply(os.path.join(out, "map.ply"))
        with open(os.path.join(out, "summary.json")) as f:
            summary = json.load(f)
    # the CLI's synthetic survey: the bench's trajectory and prior noise
    gt = np.stack(make_survey_trajectory(n_frames, altitude=30.0, speed=1.2))
    priors = np.stack(perturb_poses(list(gt), translation_sigma=0.15,
                                    rotation_sigma=0.01, seed=1))
    assert traj.shape == (n_frames, 4, 4) and np.isfinite(traj).all(), "trajectory"
    ate_full, ate_prior = ate_rmse(traj, gt), ate_rmse(priors, gt)
    assert ate_full < ate_prior, f"ATE {ate_full} m vs prior-only {ate_prior} m"
    assert len(points) > 0, "empty map"
    log(f"phase 5 ok: apps/reconstruct.py --synthetic {n_frames} (bench rig): "
        f"ATE {ate_full:.4f} m vs prior-only {ate_prior:.4f} m, "
        f"{len(points)} map points, {summary['frames_per_s']:.2f} frames/s over "
        f"{wall:.1f} s including synthetic rendering and compilation")

    # steady state on pre-rendered, pre-uploaded frames: the frame period
    # with the kernel and with aggregate_scan
    frames = render_frames(dataset, n_warmup + n_timed)
    period = {}
    for agg in ("cuda", "scan"):
        cfg_a = cfg.replace(stereo=dataclasses.replace(cfg.stereo, aggregation=agg))
        elapsed, _ = bench._run_engine(cfg_a, rig, frames, n_warmup, n_timed,
                                       pre_upload=True)
        period[agg] = elapsed / n_timed
    assert period["cuda"] < period["scan"], f"frame period {period}"
    log(f"phase 5 ok: frame period ({n_timed} timed frames, device-resident): "
        f"with the kernel {period['cuda'] * 1e3:.3f} ms "
        f"({1.0 / period['cuda']:.2f} frames/s), with aggregate_scan "
        f"{period['scan'] * 1e3:.3f} ms ({1.0 / period['scan']:.2f} frames/s)")


def spans(array, n_devices: int) -> bool:
    return len(array.sharding.device_set) == n_devices


def phase_four_gpus(n_dev: int = 4, h: int = 384, w: int = 512, d: int = 64,
                    ba_shape=(64, 2048, 512), n_points: int = 1 << 20,
                    n_frames: int = 32) -> None:
    """The sharded paths on an ``n_dev`` mesh against their one-device
    forms (the defaults are the real sizes; tests pass smaller ones)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from scipy.spatial import cKDTree

    from online_3d_reconstruction.ba.schur import solve_ba
    from online_3d_reconstruction.config import StereoConfig
    from online_3d_reconstruction.geometry.backproject import PointCloud
    from online_3d_reconstruction.io.calibration import identity_rig
    from online_3d_reconstruction.io.synthetic import SyntheticScene, nadir_pose
    from online_3d_reconstruction.mapping.voxel import voxel_downsample
    from online_3d_reconstruction.parallel import make_mesh
    from online_3d_reconstruction.parallel.ba_sharded import solve_ba_slot_sharded
    from online_3d_reconstruction.parallel.sgm_sharded import sharded_disparity
    from online_3d_reconstruction.parallel.voxel_sharded import voxel_route_merge
    from online_3d_reconstruction.runtime.distributed import reconstruct_distributed
    from online_3d_reconstruction.runtime.pipeline import reconstruct
    from online_3d_reconstruction.stereo.sgm import sgm_disparity
    from online_3d_reconstruction.utils.metrics import ate_rmse

    mesh = make_mesh(n_dev)
    rows = NamedSharding(mesh, P(mesh.axis_names[0]))

    # row-slab SGM with halo exchange against the monolithic stage
    rig = identity_rig(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, baseline=0.5,
                       width=w, height=h)
    frame = SyntheticScene(seed=3).render_stereo(nadir_pose(0.0, 0.0, 30.0), rig)
    cfg = StereoConfig(height=h, width=w, max_disparity=d, num_paths=8)
    left, right = jnp.asarray(frame.left), jnp.asarray(frame.right)
    d_ref, v_ref = sgm_disparity(left, right, cfg)
    d_sh, v_sh = sharded_disparity(jax.device_put(left, rows),
                                   jax.device_put(right, rows), cfg, mesh,
                                   halo=min(32, h // n_dev - 1))
    both = np.asarray(v_ref) & np.asarray(v_sh)
    err = np.abs(np.asarray(d_ref)[both] - np.asarray(d_sh)[both])
    exact, close = float((err < 0.01).mean()), float((err <= 1.0).mean())
    assert both.mean() > 0.5 and exact > 0.95 and close > 0.995, (exact, close)
    assert spans(d_sh, n_dev), d_sh.sharding
    log(f"phase 6 ok: sharded_disparity {w}x{h} D{d} on {n_dev} devices: "
        f"exact {exact:.4f}, within 1 px {close:.4f} of sgm_disparity")

    # keyframe-sharded Schur solve against the one-device solve
    w_kf, l_lm, k = ba_shape
    problem = ba_problem(w_kf, l_lm, k)
    p_ref = solve_ba(problem, iters=5, damping=1e-4, huber_delta=0.5,
                     slot_major=k)[0]
    p_sh = solve_ba_slot_sharded(problem, mesh, slot_major=k, iters=5,
                                 damping=1e-4, huber_delta=0.5)[0]
    dt, dr = pose_differences(p_ref, p_sh)
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)
    assert spans(p_sh, n_dev), p_sh.sharding
    log(f"phase 6 ok: solve_ba_slot_sharded W={w_kf} L={l_lm} vs solve_ba: "
        f"max translation {dt:.3e} m, rotation {dr:.3e} rad")

    # owner-routed voxel merge against the one-device voxel filter
    rng = np.random.default_rng(5)
    cloud = PointCloud(
        points=jnp.asarray(rng.normal(0, 20, (n_points, 3)).astype(np.float32)),
        colors=jnp.asarray(rng.random((n_points, 3)).astype(np.float32)),
        valid=jnp.asarray(rng.random(n_points) < 0.9),
    )
    ref = voxel_downsample(cloud, voxel_size=0.25, bounds=2048.0)
    out, dropped = voxel_route_merge(*(jax.device_put(x, rows) for x in cloud),
                                     mesh, voxel_size=0.25, bounds=2048.0)
    ref_pts = np.asarray(ref.points)[np.asarray(ref.valid)]
    out_pts = np.asarray(out.points)[np.asarray(out.valid)]
    assert int(dropped) == 0 and len(ref_pts) == len(out_pts), (
        int(dropped), len(ref_pts), len(out_pts))
    # pair each merged centroid with its nearest reference centroid: sums
    # of 3+ points round differently in the two orders, so sorting by
    # float coordinates could swap near-ties
    dist, nearest = cKDTree(ref_pts).query(out_pts)
    assert dist.max() <= 1e-4 and len(np.unique(nearest)) == len(ref_pts), (
        float(dist.max()), len(np.unique(nearest)), len(ref_pts))
    assert spans(out.points, n_dev), out.points.sharding
    log(f"phase 6 ok: voxel_route_merge {n_points} points: {len(out_pts)} "
        f"voxels, each within {float(dist.max()):.1e} m of voxel_downsample's")

    # the distributed online loop against the one-device loop
    import bench

    _, rig, dataset, cfg, _, _ = bench._make_bench_setup()
    frames = render_frames(dataset, n_frames)
    gt = np.stack([f.gt_pose for f in frames])
    priors = np.stack([f.prior_pose for f in frames])
    ate_prior = ate_rmse(priors, gt)
    ate_one = ate_rmse(reconstruct(frames, cfg, rig).trajectory, gt)
    res = reconstruct_distributed(frames, cfg, rig, mesh)
    ate_dist = ate_rmse(res.trajectory, gt)
    assert np.isfinite(res.trajectory).all() and len(res.map_points) > 0
    assert ate_dist < ate_prior and ate_one < ate_prior, (ate_dist, ate_one, ate_prior)
    log(f"phase 6 ok: reconstruct_distributed on {n_dev} devices, {n_frames} "
        f"frames: ATE {ate_dist:.4f} m (one device {ate_one:.4f} m, "
        f"prior-only {ate_prior:.4f} m), {len(res.map_points)} map points")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only phase 6, the sharded paths on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    want = 4 if args.four_gpus else 1
    if devices[0].platform != "gpu" or len(devices) < want:
        print(f"chip_smoke.py needs {want} CUDA GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform!r} device(s)", file=sys.stderr)
        return 2
    from bench import card_info

    CARD = card_info()
    from online_3d_reconstruction.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"phase 1 ok: {len(devices)} x {devices[0].device_kind}; compile cache "
        f"{cache} holds {entries} entries")

    phases = ([phase_four_gpus] if args.four_gpus else
              [phase_kernel, phase_disparity, phase_cpu_vs_gpu, phase_main_path])
    failed = []
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:   # report every phase, then fail the run
            failed.append(phase.__name__)
            log(f"FAILED {phase.__name__}:\n{traceback.format_exc()}")
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
