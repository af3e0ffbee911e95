"""Whole-dispatch device timing of the bench's steady-state frame programs.

Closes the attribution gap tools/profile_frame_parts.py leaves: that tool
times the pipeline stages in isolation, which do not sum to the bench frame
period. This times the ACTUAL fused per-frame programs the bench
dispatches (_steady_step and _steady_step_kf at the exact bench config,
donated buffers replaced per call) plus the remaining small pieces (unpack,
color remap, map insert, the amortized flush_staging) so

    frame_period_device_resident  =  fused program + dispatch overhead

becomes an identity made of measured terms.

Usage: python tools/profile_steady.py   (from the repo root)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.ba.device_tracks import build_problem
from online_3d_reconstruction.ba.problem import StereoNoiseModel
from online_3d_reconstruction.ba.schur import solve_ba
from online_3d_reconstruction.geometry.backproject import PointCloud
from online_3d_reconstruction.mapping.global_map import (
    create_map,
    flush_staging,
    insert_cloud,
)
from online_3d_reconstruction.runtime.pipeline import (
    _steady_step,
    _steady_step_kf,
    unpack_frame,
)
from online_3d_reconstruction.utils.compile_cache import enable_compile_cache
from online_3d_reconstruction.utils.roofline import measure_amortized


def bench_setup():
    import bench

    hwd, rig, dataset, cfg, n_warmup, n_timed = bench._make_bench_setup()
    return hwd, rig, dataset, cfg


def main():
    enable_compile_cache()
    print("backend:", jax.default_backend(), flush=True)
    (h, w, d), rig, dataset, cfg = bench_setup()
    frames = [dataset[i] for i in range(14)]
    print("rendered", flush=True)

    from online_3d_reconstruction.runtime.pipeline import OnlineReconstructor

    engine = OnlineReconstructor(cfg, rig)
    for f in frames[:12]:
        engine.process(f)
    jax.block_until_ready(engine.gmap.points)
    print("warm engine ready", flush=True)

    kf = engine.keyframes[-1]
    packed_np = engine.pack(frames[12], frame_index=12)
    packed = jax.device_put(packed_np)
    maps = (engine.map_left, engine.map_right, engine.q)
    scfg, fcfg, ocfg, mcfg, xcfg = (cfg.stereo, cfg.features, cfg.odometry,
                                    cfg.mapping, cfg.matching)

    rows = []

    def report(name, sec):
        rows.append((name, sec))
        print(f"{name:46s} {sec * 1e3:8.3f} ms", flush=True)

    # donated args must be fresh per call inside the amortized scan: pass the
    # map/window through the scan carry instead — measure_amortized only
    # perturbs the first f32 arg, so wrap with explicit copies via jnp.add.
    staging_shape = engine._staging
    ba_shape = engine._ba_state

    def steady(eps, pk):
        gmap = jax.tree.map(
            lambda x: x + jnp.zeros((), x.dtype) if x.dtype != bool
            else x, staging_shape)
        out = _steady_step(gmap, pk, *maps, kf.features, kf.pose,
                           kf.prior_pose, engine._key,
                           scfg, fcfg, ocfg, mcfg, xcfg,
                           True, False, engine._skip_rectify, engine._bands)
        return out[1], out[4], out[5]

    def steady_kf(eps, pk):
        gmap = jax.tree.map(
            lambda x: x + jnp.zeros((), x.dtype) if x.dtype != bool
            else x, staging_shape)
        ba = jax.tree.map(
            lambda x: x + jnp.zeros((), x.dtype) if x.dtype != bool
            else x, ba_shape)
        out = _steady_step_kf(gmap, ba, pk, *maps, kf.features, kf.pose,
                              kf.prior_pose, engine._key,
                              scfg, fcfg, ocfg, mcfg, xcfg, cfg.ba,
                              True, False, engine._skip_rectify,
                              engine._noise_model, engine._bands)
        return out[1], out[4], out[5]

    pk_f = packed.astype(jnp.float32)  # perturbable copy source

    # pieces not covered by profile_frame_parts
    from online_3d_reconstruction.runtime.pipeline import _color_stride

    sec = measure_amortized(
        lambda eps, p: unpack_frame((p + eps).astype(jnp.uint8), h, w,
                                    _color_stride(mcfg),
                                    scfg.invalid_value, False),
        (jnp.float32(0.0), pk_f), inner=16)
    report("unpack_frame (u8 planes -> f32)", sec)

    n_pts = engine._frame_points
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.normal(0, 5, (n_pts, 3)).astype(np.float32))
    cols = jnp.asarray(rng.random((n_pts, 3)).astype(np.float32))
    ok = jnp.asarray(np.ones(n_pts, bool))

    def ins(eps, p):
        gmap = jax.tree.map(
            lambda x: x + jnp.zeros((), x.dtype) if x.dtype != bool else x,
            staging_shape)
        return insert_cloud(gmap, PointCloud(p + eps, cols, ok)).cursor

    sec = measure_amortized(ins, (jnp.float32(0.0), pts), inner=16)
    report("insert_cloud (staging pool)", sec)

    def flush(eps, p):
        gmap = jax.tree.map(
            lambda x: x + jnp.zeros((), x.dtype) if x.dtype != bool else x,
            engine.gmap)
        stag = jax.tree.map(
            lambda x: x + jnp.zeros((), x.dtype) if x.dtype != bool else x,
            staging_shape)
        stag = stag._replace(points=stag.points + eps)
        g2, s2 = flush_staging(gmap, stag, mcfg.voxel_size, mcfg.bounds)
        return g2.cursor

    sec = measure_amortized(flush, (jnp.float32(0.0), pts), inner=4,
                            max_inner=16)
    ds_every = mcfg.downsample_every
    report(f"flush_staging (amortize /{ds_every} frames)", sec)

    # BA pieces at the exact product window configuration
    state = ba_shape
    nm = engine._noise_model
    wt = cfg.ba.window
    lt = cfg.ba.max_landmarks

    def build(eps, p3d):
        st = state._replace(points3d=state.points3d + eps)
        problem, _ = build_problem(st, cfg.ba.max_landmarks, nm)
        return problem.landmarks, problem.obs_valid

    sec = measure_amortized(build, (jnp.float32(0.0), state.points3d),
                            inner=8)
    report(f"  ba build_problem (W={wt}/L={lt}, tracks+info)", sec)

    problem, _ = build_problem(state, cfg.ba.max_landmarks, nm)

    sec = measure_amortized(
        lambda eps, p: solve_ba(
            p._replace(obs_point=p.obs_point + eps), iters=cfg.ba.gn_iters,
            damping=cfg.ba.damping, huber_delta=cfg.ba.huber_delta,
            anchor_first=False,
            prior_position_weight=cfg.ba.prior_position_weight,
            prior_rotation_weight=cfg.ba.prior_rotation_weight,
            slot_major=fcfg.max_keypoints),
        (jnp.float32(0.0), problem), inner=8)
    report(f"  ba solve_ba (W={wt} slot-major, {cfg.ba.gn_iters} it)", sec)

    # the fused per-frame programs LAST: their inner-scan wrappers are the
    # largest programs this repo compiles — a failure here must not lose
    # the component rows above. inner=4 keeps the program smaller.
    for name, fn in (("FUSED _steady_step (non-kf frame)", steady),
                     ("FUSED _steady_step_kf (keyframe frame)", steady_kf)):
        try:
            sec = measure_amortized(
                lambda eps, p, fn=fn: fn(eps, (p + eps).astype(jnp.uint8)),
                (jnp.float32(0.0), pk_f), inner=4)
            report(name, sec)
        except Exception as e:  # noqa: BLE001
            print(f"{name}: FAILED ({type(e).__name__}: {e})", flush=True)

    # per-dispatch overhead = bench frame period (build/bench_detail.json
    # frame_period_device_resident) minus the fused program time above


if __name__ == "__main__":
    main()
