"""Piecewise timing of the sgm_disparity stage on the device: census,
cost volume build, aggregation (the implementation ``stereo.aggregation``
resolves to), WTA, right/LR, speckle.

Usage: python tools/profile_stage_parts.py   (from the repo root)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.stereo.census import census_transform, cost_volume
from online_3d_reconstruction.stereo.sgm import (
    aggregate,
    lr_consistency_mask_volume,
    right_disparity_from_aggregated,
    sgm_disparity,
    speckle_filter,
    wta_disparity,
)
from online_3d_reconstruction.config import StereoConfig
from online_3d_reconstruction.utils.compile_cache import enable_compile_cache
from online_3d_reconstruction.utils.roofline import measure_amortized


def main():
    enable_compile_cache()
    print("backend:", jax.default_backend(), flush=True)
    h, w, d = 384, 512, 64
    cfg = StereoConfig(height=h, width=w, max_disparity=d, num_paths=8)
    rng = np.random.default_rng(0)
    left = jnp.asarray(rng.random((h, w), dtype=np.float32))
    right = jnp.asarray(rng.random((h, w), dtype=np.float32))

    sec = measure_amortized(
        lambda eps, l: census_transform(l + eps, (5, 5)),
        (jnp.float32(0.0), left), inner=32)
    print(f"census x1: {sec*1e3:.3f} ms", flush=True)

    cen_l = census_transform(left, (5, 5))
    cen_r = census_transform(right, (5, 5))

    def cost_fn(eps, l):
        cl = census_transform(l + eps, (5, 5))
        return cost_volume(cl, cen_r, d).astype(jnp.bfloat16)

    sec = measure_amortized(cost_fn, (jnp.float32(0.0), left), inner=16)
    print(f"census+cost_volume->bf16: {sec*1e3:.3f} ms", flush=True)

    costf = cost_volume(cen_l, cen_r, d).astype(jnp.float32)

    sec = measure_amortized(
        lambda eps, c: aggregate(c + eps, cfg),
        (jnp.float32(0.0), costf), inner=16)
    print(f"aggregate 8p {cfg.cost_dtype}: {sec*1e3:.3f} ms", flush=True)

    agg = aggregate(costf, cfg)

    sec = measure_amortized(
        lambda eps, a: wta_disparity(a + eps, 0.95, True),
        (jnp.float32(0.0), agg), inner=16)
    print(f"wta: {sec*1e3:.3f} ms", flush=True)

    sec = measure_amortized(
        lambda eps, a: right_disparity_from_aggregated(a + eps),
        (jnp.float32(0.0), agg), inner=16)
    print(f"right_disparity_from_aggregated: {sec*1e3:.3f} ms", flush=True)

    disp, valid = wta_disparity(agg, 0.95, True)
    disp_r = right_disparity_from_aggregated(agg)

    sec = measure_amortized(
        lambda eps, dd: lr_consistency_mask_volume(dd + eps, disp_r, d, 1),
        (jnp.float32(0.0), disp), inner=32)
    print(f"lr_consistency (volume form): {sec*1e3:.3f} ms", flush=True)

    sec = measure_amortized(
        lambda eps, dd: speckle_filter(dd + eps, valid, 50, 1.0),
        (jnp.float32(0.0), disp), inner=8)
    print(f"speckle_filter (run-cross mass): {sec*1e3:.3f} ms", flush=True)

    sec = measure_amortized(
        lambda eps, l, r: sgm_disparity(l + eps, r, cfg)[0],
        (jnp.float32(0.0), left, right), inner=8)
    print(f"FULL sgm_disparity 8-path bf16: {sec*1e3:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
