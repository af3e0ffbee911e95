"""Row-slab sharded SGM (P4): intra-image tiling across chips.

The SGM path scan is this workload's "long context" (SURVEY.md §5): a
sequential recurrence along image rows/columns/diagonals. To split one image
across chips we shard rows into slabs, and each device aggregates over its
slab *plus a halo of overlap rows* fetched from its neighbors — structurally
the neighbor exchange of ring attention, done here with one ``ppermute``
per direction before the scan instead of per step.

Exactness: horizontal paths never cross slab boundaries and are exact.
Vertical/diagonal paths are truncated at the halo edge — the standard tiled-
SGM approximation; the SGM normalization bounds a path's influence (each
step's carry is clamped within P2 of the running min), so influence decays
and a halo of ~16-32 rows makes interior pixels match the monolithic result
almost everywhere (asserted in tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from online_3d_reconstruction.config import StereoConfig
from online_3d_reconstruction.stereo.census import census_transform, cost_volume
from online_3d_reconstruction.stereo.sgm import (
    aggregate,
    disparity_from_aggregated,
    speckle_filter,
)


def _exchange_halos(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Prepend the previous shard's last rows and append the next shard's
    first rows: (S, ...) -> (S + 2*halo, ...). Edge shards get zero padding
    (same as an image border)."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    down = [(i, (i + 1) % n) for i in range(n)]   # send to next
    up = [(i, (i - 1) % n) for i in range(n)]     # send to prev
    from_prev = jax.lax.ppermute(x[-halo:], axis_name, down)
    from_next = jax.lax.ppermute(x[:halo], axis_name, up)
    zeros = jnp.zeros_like(from_prev)
    from_prev = jnp.where(idx > 0, from_prev, zeros)
    from_next = jnp.where(idx < n - 1, from_next, zeros)
    return jnp.concatenate([from_prev, x, from_next], axis=0)


@partial(jax.jit, static_argnames=("config", "mesh", "halo"))
def sharded_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    config: StereoConfig,
    mesh: Mesh,
    halo: int = 32,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One stereo pair, rows sharded over the mesh: (H, W) -> (H, W) disparity.

    H must divide by the device count and slab height must exceed the halo.
    Census runs on halo-extended image slabs (window support), aggregation on
    halo-extended cost slabs; each device keeps its interior. The speckle
    filter is global connectivity and runs replicated after a gather — it is
    cheap relative to aggregation.
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    h, w = left.shape
    if h % n_dev:
        raise ValueError(f"height {h} not divisible by {n_dev} devices")
    slab = h // n_dev
    if slab <= halo:
        raise ValueError(f"slab {slab} rows must exceed halo {halo}")

    def stage(left_s, right_s):
        # census needs window support: exchange a small halo of raw rows
        cw = max(config.census_window) // 2
        pad = halo + cw
        left_e = _exchange_halos(left_s, pad, axis)
        right_e = _exchange_halos(right_s, pad, axis)
        cen_l = census_transform(left_e, config.census_window)
        cen_r = census_transform(right_e, config.census_window)

        cost = cost_volume(cen_l, cen_r, config.max_disparity)
        cost = cost[cw:-cw] if cw else cost  # keep slab + aggregation halo
        agg = aggregate(cost, config)[halo:halo + slab]  # interior only
        return disparity_from_aggregated(agg, config)

    disp, valid = shard_map(
        stage, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    )(left, right)

    if config.speckle_window > 0:
        valid = speckle_filter(disp, valid, config.speckle_window,
                               config.speckle_range)
    disp = jnp.where(valid, disp, config.invalid_value)
    return disp, valid
