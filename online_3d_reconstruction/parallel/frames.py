"""Frame-batch parallelism (P1): independent per-frame work over the mesh.

The reference processes one frame at a time on one machine; per-frame stereo
work (rectify, census, SGM, features) is embarrassingly parallel across
frames, so the framework batches B frames and shards the batch
axis over the device mesh — DP in scaling-book terms (SURVEY.md §2.3 P1).
Used by the offline/bulk path and the benchmark's multi-chip config.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from online_3d_reconstruction.config import StereoConfig
from online_3d_reconstruction.stereo.sgm import sgm_disparity


def batch_disparity(
    lefts: jnp.ndarray,
    rights: jnp.ndarray,
    config: StereoConfig,
    mesh: Optional[Mesh] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(B, H, W) stereo batch -> (disparity (B, H, W), valid (B, H, W)).

    With a mesh, the batch axis is sharded across devices (jit + sharding
    constraint: XLA partitions the whole per-frame pipeline, no collectives
    needed — pure data parallelism).
    """
    fn = jax.vmap(lambda l, r: sgm_disparity(l, r, config))
    if mesh is None:
        return jax.jit(fn)(lefts, rights)
    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))
    lefts = jax.device_put(lefts, sharding)
    rights = jax.device_put(rights, sharding)
    out_shardings = (sharding, sharding)
    return jax.jit(fn, out_shardings=out_shardings)(lefts, rights)
