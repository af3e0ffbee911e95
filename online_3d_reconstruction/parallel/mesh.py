"""Device-mesh construction for multi-chip runs.

The reference has no distributed path (SURVEY.md §2.4); the framework
scales with ``jax.sharding.Mesh`` + ``shard_map``. One linear mesh
axis (default ``"d"``) covers every parallelism strategy in §2.3: frame-batch
(P1), observation-sharded BA (P2), and point-sharded voxel merge (P3).
Multi-host: call ``jax.distributed.initialize()`` before ``make_mesh()`` and
the same code spans all hosts' devices.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

DEFAULT_AXIS = "d"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DEFAULT_AXIS) -> Mesh:
    """Linear mesh over the first ``n_devices`` devices (all by default)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
