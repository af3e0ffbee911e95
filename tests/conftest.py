"""Test env: 8 virtual CPU devices, and the ``gpu`` fixture.

The suite runs on the CPU (run it with ``JAX_PLATFORMS=cpu``); the
multi-device sharding tests need >1 device, which the CPU platform
simulates (SURVEY.md §4.4). The flags must be set before the first
``import jax``.

Tests marked ``gpu`` need a CUDA GPU; they take the ``gpu`` fixture, which
skips them when JAX's default backend is not a GPU. Run them on the card
with ``python -m pytest -m gpu tests/``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in _flags:
    # XLA:CPU *kills the whole process* (SIGABRT, "Exiting to ensure a
    # consistent program state") when the 8 virtual devices fail to join
    # a collective rendezvous within its default timeout — which an
    # oversubscribed small host (2-core CI box running the distributed
    # shard_map tests) routinely triggers mid-compile. Raise it far past
    # any legitimate suite stall; real deadlocks still die, just slower.
    _flags += (" --xla_cpu_collective_call_terminate_timeout_seconds=1200"
               " --xla_cpu_collective_call_warn_stuck_timeout_seconds=120")
os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402

from online_3d_reconstruction.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

# Multi-device (8-replica shard_map) programs deadlock in XLA:CPU's
# collective rendezvous when run mid-suite on a small host (all threads
# futex-parked at zero CPU; XLA's termination timeout then SIGABRTs the
# whole process). The same modules pass reliably in a FRESH process, so the
# suite runs them through tests/test_multidevice.py, which spawns each heavy
# module in its own subprocess (with O3R_INNER=1). Direct invocation of a
# heavy module still works: explicit file paths on the command line are not
# subject to collect_ignore.
_HEAVY_MODULES = ["test_distributed.py", "test_parallel.py"]
if os.environ.get("O3R_INNER") != "1":
    collect_ignore = list(_HEAVY_MODULES)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from online_3d_reconstruction.io.calibration import identity_rig  # noqa: E402
from online_3d_reconstruction.io.synthetic import (  # noqa: E402
    Plateau,
    SyntheticScene,
    nadir_pose,
)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU; JAX's default backend is "
                    f"{device.platform!r}")
    return device


@pytest.fixture(scope="session")
def small_rig():
    """A 192x256 pre-rectified rig — small enough for fast CPU tests."""
    return identity_rig(fx=200.0, fy=200.0, cx=128.0, cy=96.0, baseline=0.5,
                        width=256, height=192)


@pytest.fixture(scope="session")
def scene():
    return SyntheticScene(
        seed=3,
        plateaus=[Plateau(x_min=-4.0, x_max=4.0, y_min=-3.0, y_max=5.0, height=6.0)],
    )


@pytest.fixture(scope="session")
def stereo_frame(scene, small_rig):
    return scene.render_stereo(nadir_pose(0.0, 0.0, 24.0), small_rig)
