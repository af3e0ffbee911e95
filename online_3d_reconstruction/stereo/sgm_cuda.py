"""SGM path aggregation on an NVIDIA GPU: the CUDA kernel and its wrapper.

``sgm_aggregate.cu`` (beside this file) holds the recurrence: one warp per
path, the disparities across the warp's lanes, d+-1 and the min over D by
warp shuffles, every direction's chains in one launch. This module holds
everything around it, in Python that the CPU tests reach:

- ``path_table``: which chains of pixels the warps walk, per direction;
- the build: ``nvcc`` compiles the kernel into ``<checkout>/build/`` on first
  use (the library name carries a hash of the source, so an edit rebuilds);
- ``aggregate_cuda``: the call through ``jax.ffi``, in the same (H, W, D)
  layout and with the same result as ``sgm.aggregate_scan``.

The kernel has no interpret mode; ``sgm.aggregate_scan`` is its reference.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.utils.compile_cache import CHECKOUT

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sgm_aggregate.cu")
_BUILD_DIR = os.path.join(CHECKOUT, "build")
_TARGET = "o3r_sgm_aggregate"
MAX_DISPARITY = 256   # K = D/32 disparities per lane, K <= 8 in the kernel

# (dy, dx) of each direction, in the order of the output planes. The first
# 2 / 4 / 8 are the 2-, 4- and 8-path sets of ``sgm.aggregate_scan``.
DIRECTIONS = ((0, 1), (0, -1), (1, 0), (-1, 0),
              (1, 1), (-1, -1), (1, -1), (-1, 1))


def path_table(h: int, w: int, num_paths: int) -> np.ndarray:
    """Chains of pixels for ``num_paths`` directions: int32 (N, 4) rows of
    (start pixel y*W+x, pixel stride, length, direction index).

    Each direction's chains cover every pixel exactly once, and each chain
    starts at a pixel whose predecessor lies outside the image (the fresh
    start of the recurrence). Rows are sorted longest first, so the long
    chains are scheduled first and the short diagonals fill the tail.
    """
    if num_paths not in (2, 4, 8):
        raise ValueError(f"num_paths must be 2, 4, or 8, got {num_paths}")
    rows: List[tuple] = []
    for k, (dy, dx) in enumerate(DIRECTIONS[:num_paths]):
        stride = dy * w + dx
        y_first = 0 if dy > 0 else h - 1
        x_first = 0 if dx > 0 else w - 1
        if dy == 0:       # one chain per row
            starts = [(y, x_first) for y in range(h)]
        elif dx == 0:     # one chain per column
            starts = [(y_first, x) for x in range(w)]
        else:             # the first row, then the first column below it
            starts = ([(y_first, x) for x in range(w)]
                      + [(y_first + dy * j, x_first) for j in range(1, h)])
        for y, x in starts:
            n_y = h - y if dy > 0 else (y + 1 if dy < 0 else h + w)
            n_x = w - x if dx > 0 else (x + 1 if dx < 0 else h + w)
            rows.append((y * w + x, stride, min(n_y, n_x), k))
    table = np.asarray(rows, dtype=np.int32)
    return table[np.argsort(-table[:, 2], kind="stable")]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("building the SGM kernel needs nvcc (the CUDA toolkit)")
    return found


@functools.cache
def _register() -> str:
    """Build (once per source version) and register the FFI target."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    lib_path = os.path.join(_BUILD_DIR, f"libo3r_sgm-{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=600)
        except subprocess.CalledProcessError as e:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed:\n{e.stderr}") from e
        os.replace(tmp, lib_path)   # atomic: a concurrent build loses nothing
    lib = ctypes.cdll.LoadLibrary(lib_path)
    jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(lib.O3rSgmAggregate),
                                platform="CUDA")
    return _TARGET


def aggregate_cuda(cost: jnp.ndarray, p1: float, p2: float,
                   num_paths: int = 4, dtype=jnp.float32) -> jnp.ndarray:
    """Sum of directional SGM aggregations over 2, 4, or 8 paths, on the GPU.

    cost: (H, W, D) matching costs, stored in ``dtype`` (float32 or
    bfloat16) for the kernel's reads and its per-direction writes. Returns
    (H, W, D) float32, equal to ``sgm.aggregate_scan(cost, p1, p2,
    num_paths, dtype)``.
    """
    h, w, d = cost.shape
    if d > MAX_DISPARITY:
        raise ValueError(f"the SGM kernel takes D <= {MAX_DISPARITY}, got {d}")
    table = jnp.asarray(path_table(h, w, num_paths))
    planes = jax.ffi.ffi_call(
        _register(),
        jax.ShapeDtypeStruct((num_paths, h, w, d), jnp.dtype(dtype)),
        vmap_method="sequential",
    )(cost.astype(dtype), table, p1=np.float32(p1), p2=np.float32(p2))
    return jnp.sum(planes.astype(jnp.float32), axis=0)
