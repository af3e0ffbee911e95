"""Device-time attribution of the WHOLE steady-state frame.

stage_means (host enqueue times) don't sum to the device-resident frame
period. This tool times each jitted sub-stage of the fused per-frame
dispatch with the amortized in-scan method (utils/roofline.measure_amortized
— dispatch overhead cancels) at the exact bench configuration (distorted rig, 512x384,
D=64, 8-path bf16 SGM, 512 keypoints), so the pieces can be compared against
the measured frame period.

Usage: python tools/profile_frame_parts.py   (from the repo root)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.config import (
    FeatureConfig,
    MatchConfig,
    OdometryConfig,
    StereoConfig,
)
from online_3d_reconstruction.geometry.backproject import backproject_disparity
from online_3d_reconstruction.io.calibration import (
    CameraIntrinsics,
    StereoCalibration,
    stereo_rectify,
)
from online_3d_reconstruction.io.synthetic import (
    Plateau,
    SyntheticScene,
    nadir_pose,
)
from online_3d_reconstruction.odometry.frontend import (
    extract_frame_features,
    tracking_step,
)
from online_3d_reconstruction.stereo.rectify import (
    rectify_pair,
    vertical_band,
)
from online_3d_reconstruction.stereo.sgm import sgm_disparity
from online_3d_reconstruction.utils.compile_cache import enable_compile_cache
from online_3d_reconstruction.utils.roofline import measure_amortized


def main():
    enable_compile_cache()
    print("backend:", jax.default_backend(), flush=True)
    h, w, d = 384, 512, 64
    cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2,
                           width=w, height=h,
                           dist=(-0.08, 0.01, 3e-4, -3e-4, 0.0))
    calib = StereoCalibration(left=cam, right=cam,
                              translation=np.array([-0.5, 0.0, 0.0]))
    rig = stereo_rectify(calib)
    scene = SyntheticScene(seed=5, plateaus=[Plateau(-6., 6., -4., 8., 8.)],
                           supersample=2)
    f0 = scene.render_stereo(nadir_pose(0.0, 0.0, 30.0), rig, calib=calib)
    f1 = scene.render_stereo(nadir_pose(1.2, 0.0, 30.0), rig, calib=calib)

    stereo_cfg = StereoConfig(height=h, width=w, max_disparity=d, num_paths=8)
    feat_cfg = FeatureConfig(max_keypoints=512, fast_threshold=5.0)
    odo_cfg = OdometryConfig(ransac_threshold=0.5, max_point_depth=60.0)
    match_cfg = MatchConfig()

    q = jnp.asarray(rig.q, dtype=jnp.float32)
    map_l = jnp.asarray(rig.map_left)
    map_r = jnp.asarray(rig.map_right)
    bl = vertical_band(rig.map_left)
    br = vertical_band(rig.map_right)
    left0 = jnp.asarray(f0.left)
    right0 = jnp.asarray(f0.right)
    left1 = jnp.asarray(f1.left)
    right1 = jnp.asarray(f1.right)

    rows = []

    def report(name, sec):
        rows.append((name, sec))
        ms = sec * 1e3 if sec == sec else float("nan")
        print(f"{name:42s} {ms:8.3f} ms", flush=True)

    # rectify (banded matmul form, both gray views)
    sec = measure_amortized(
        lambda eps, l, r: rectify_pair(l + eps, r, map_l, map_r,
                                       band_left=bl, band_right=br),
        (jnp.float32(0.0), left0, right0), inner=32)
    report("rectify_pair banded (2 views)", sec)

    lr0, rr0 = rectify_pair(left0, right0, map_l, map_r, bl, br)
    lr1, rr1 = rectify_pair(left1, right1, map_l, map_r, bl, br)

    # whole disparity stage
    sec = measure_amortized(
        lambda eps, l, r: sgm_disparity(l + eps, r, stereo_cfg)[0],
        (jnp.float32(0.0), lr0, rr0), inner=8)
    report("sgm_disparity (8p bf16 full)", sec)

    disp0, _ = sgm_disparity(lr0, rr0, stereo_cfg)
    disp1, _ = sgm_disparity(lr1, rr1, stereo_cfg)

    # features: detect + subpixel + describe + 3D lift
    sec = measure_amortized(
        lambda eps, l: extract_frame_features(l + eps, disp0, q, feat_cfg,
                                              odo_cfg),
        (jnp.float32(0.0), lr0), inner=8)
    report("extract_frame_features (512 kp)", sec)

    feats0 = extract_frame_features(lr0, disp0, q, feat_cfg, odo_cfg)
    feats1 = extract_frame_features(lr1, disp1, q, feat_cfg, odo_cfg)

    # tracking: match + RANSAC + rot-prior GN + compose
    key = jax.random.PRNGKey(0)
    eye = jnp.eye(4, dtype=jnp.float32)
    prior = eye.at[0, 3].set(1.2)

    def track(eps, p3d):
        return tracking_step(feats1._replace(points3d=p3d + eps), feats0,
                             eye, eye, prior, key, jnp.int32(1),
                             match_cfg, odo_cfg)[0]

    sec = measure_amortized(track, (jnp.float32(0.0), feats1.points3d),
                            inner=8)
    report("tracking_step (match+RANSAC+GN)", sec)

    # backprojection (stride 2) — fusion's producer
    sec = measure_amortized(
        lambda eps, dd: backproject_disparity(dd + eps, lr0, q, stride=2,
                                              min_depth=1.0, max_depth=60.0),
        (jnp.float32(0.0), disp0), inner=16)
    report("backproject_disparity (stride 2)", sec)

    # BA keyframe event (window append + track build + W=8 Schur solve)
    from online_3d_reconstruction.ba.device_tracks import (
        create_window,
        keyframe_core,
    )
    from online_3d_reconstruction.config import BAConfig
    from online_3d_reconstruction.ba.problem import StereoNoiseModel

    ba_cfg = BAConfig(obs_weighting=True, sigma_pixel=0.5,
                      sigma_disparity=0.5, huber_delta=3.0,
                      prior_position_weight=1.0 / 0.15**2,
                      prior_rotation_weight=1.0 / 0.01**2)
    nm = StereoNoiseModel(fx=rig.fx, fy=rig.fy, baseline=rig.baseline,
                          sigma_px=0.5, sigma_disparity=0.5)
    state = create_window(ba_cfg.window, feat_cfg.max_keypoints)
    kp = feat_cfg.max_keypoints
    m_idx = jnp.arange(kp, dtype=jnp.int32)
    m_ok = jnp.ones(kp, bool)
    state, _, _ = keyframe_core(state, feats0.points3d, feats0.valid3d,
                                m_idx, jnp.zeros(kp, bool), eye, eye, ba_cfg,
                                noise_model=nm)

    def ba_step(eps, pts):
        s2, refined, _ = keyframe_core(state, pts + eps, feats1.valid3d,
                                       m_idx, m_ok, prior, prior, ba_cfg,
                                       noise_model=nm)
        return refined

    sec = measure_amortized(ba_step, (jnp.float32(0.0), feats1.points3d),
                            inner=8)
    report("ba keyframe_core (W=8 append+solve)", sec)

    total = sum(s for _, s in rows if s == s)
    print(f"{'SUM of stages':42s} {total*1e3:8.3f} ms", flush=True)
    print("(compare against build/bench_detail.json "
          "frame_attribution_ms.frame_period_device_resident; the remainder "
          "is map insert + unpack + per-dispatch overhead)", flush=True)


if __name__ == "__main__":
    main()
