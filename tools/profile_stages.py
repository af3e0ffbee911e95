"""Amortized per-stage timings of the online-loop components on the device.

Run: python tools/profile_stages.py   (from the repo root)

Uses utils.roofline.measure_amortized so the per-dispatch overhead is
excluded — these are kernel/XLA-program times, the numbers to optimize.
SGM aggregation runs the implementation ``stereo.aggregation="auto"``
resolves to (the CUDA kernel on a GPU).
"""

import numpy as np
import jax
import jax.numpy as jnp

from online_3d_reconstruction.config import (
    BAConfig, FeatureConfig, MatchConfig, MappingConfig, OdometryConfig,
    StereoConfig,
)
from online_3d_reconstruction.features.brief import detect_and_describe
from online_3d_reconstruction.features.match import match_descriptors
from online_3d_reconstruction.geometry.backproject import backproject_disparity
from online_3d_reconstruction.io.calibration import identity_rig
from online_3d_reconstruction.mapping.global_map import create_map, insert_cloud, downsample_map
from online_3d_reconstruction.stereo.census import census_transform, cost_volume
from online_3d_reconstruction.stereo.rectify import rectify_pair
from online_3d_reconstruction.stereo.sgm import (
    aggregate, sgm_disparity, wta_disparity, right_disparity_from_aggregated,
    speckle_filter,
)
from online_3d_reconstruction.utils.compile_cache import enable_compile_cache
from online_3d_reconstruction.utils.roofline import measure_amortized

H, W, D = 384, 512, 64


def main():
    enable_compile_cache()
    print("backend:", jax.default_backend())
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.random((H, W), np.float32))
    color = jnp.asarray(rng.random((H, W, 3), np.float32))
    cost = jnp.asarray(rng.integers(0, 24, (H, W, D)).astype(np.float32))
    rig = identity_rig(fx=400.0, fy=400.0, cx=W / 2, cy=H / 2, baseline=0.5,
                       width=W, height=H)
    q = jnp.asarray(rig.q, np.float32)
    map_l = jnp.asarray(rig.map_left)
    map_r = jnp.asarray(rig.map_right)
    scfg = StereoConfig(height=H, width=W, max_disparity=D, num_paths=8)
    fcfg = FeatureConfig(max_keypoints=512)
    ocfg = OdometryConfig()
    mcfg = MappingConfig()

    rows = []

    def bench(name, fn, args, **kw):
        sec = measure_amortized(fn, args, **kw)
        rows.append((name, sec * 1e3))
        print(f"{name:32s} {sec*1e3:8.2f} ms")

    bench("rectify_pair", lambda l: rectify_pair(l, img, map_l, map_r), (img,))
    bench("census(5x5) x2 + cost_volume",
          lambda l: cost_volume(census_transform(l, (5, 5)),
                                census_transform(img, (5, 5)), D
                                ).astype(jnp.float32),
          (img,))
    bench("sgm aggregate 8-path", lambda c: aggregate(c, scfg), (cost,))
    agg = aggregate(cost, scfg)
    bench("wta+subpixel", lambda a: wta_disparity(a, 0.95, True)[0], (agg,))
    bench("right_disp (LR)", lambda a: right_disparity_from_aggregated(a), (agg,))
    disp0, v0 = wta_disparity(agg, 0.95, True)
    bench("speckle_filter", lambda d: speckle_filter(d, d > 0, 50, 1.0), (disp0,),
          inner=4)
    bench("sgm_disparity FULL", lambda l: sgm_disparity(l, img, scfg)[0], (img,),
          inner=4)
    bench("detect_and_describe", lambda l: detect_and_describe(l, fcfg), (img,))
    desc = jnp.asarray(rng.integers(0, 2**32, (512, 8), dtype=np.uint32))
    va = jnp.ones(512, bool)
    bench("match 512x512",
          lambda eps: match_descriptors(desc, desc, va & (eps < 1e9), va),
          (jnp.float32(0.0),))
    bench("backproject s2",
          lambda d: backproject_disparity(d, color, q, stride=2,
                                          min_depth=1.0, max_depth=60.0),
          (disp0,))
    gmap = create_map(2_000_000)
    cloud = backproject_disparity(disp0, color, q, stride=2, min_depth=1.0,
                                  max_depth=60.0)
    bench("insert_cloud (2M pool)",
          lambda p: insert_cloud(gmap, cloud._replace(points=p)),
          (cloud.points,), inner=4)
    bench("downsample_map (2M pool)",
          lambda p: downsample_map(gmap._replace(points=p,
                                                 cursor=jnp.int32(400000)),
                                   0.25, 2048.0),
          (gmap.points,), inner=3)

    from online_3d_reconstruction.ba.schur import solve_ba
    from online_3d_reconstruction.ba.testing import make_synthetic_bundle
    problem, _, _ = make_synthetic_bundle(np.random.default_rng(1), w=8, l=512,
                                          obs_noise=0.02, n_cap=4096)
    bench("solve_ba w8 l512 n4096 it5",
          lambda eps, p: solve_ba(p._replace(obs_point=p.obs_point + eps),
                                  iters=5, damping=1e-4, huber_delta=0.5),
          (jnp.float32(0.0), problem), inner=4)

    total = sum(t for _, t in rows)
    print(f"{'TOTAL (sum of stages)':32s} {total:8.2f} ms")


if __name__ == "__main__":
    main()
