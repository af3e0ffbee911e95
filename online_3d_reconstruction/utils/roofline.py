"""Per-kernel roofline accounting on the GPU.

For each kernel this module pairs an analytic work model (bytes moved,
tensor-core FLOPs, CUDA-core operations) with a measured runtime and
reports achieved rates against the card's published peaks and which roof
binds. Peaks come from ``PEAKS``, keyed by ``jax.Device.device_kind``; a
device that is not in the table gets times and achieved rates but no
roofline share, never an assumed peak.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import jax
import numpy as np

# NVIDIA H100 Tensor Core GPU data sheet, dense rates (without sparsity), at
# the full power limit (700 W SXM, 350 W PCIe). A card set below it cannot
# hold its top clock under load: report its power limit beside any share.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {        # H100 SXM5
        "hbm_gbps": 3350.0,
        "tc_tflops_bf16": 989.4,
        "tc_tflops_tf32": 494.7,
        "fp32_tflops": 66.9,
    },
    "NVIDIA H100 PCIe": {
        "hbm_gbps": 2000.0,
        "tc_tflops_bf16": 756.0,
        "tc_tflops_tf32": 378.0,
        "fp32_tflops": 51.2,
    },
}


@dataclass
class RooflinePoint:
    name: str
    bytes_accessed: float
    flops: float                  # tensor-core-eligible FLOPs (bf16 products)
    vector_ops: float             # CUDA-core elementwise/min ops (f32)
    seconds: float
    notes: str = ""

    @property
    def arithmetic_intensity(self) -> float:
        return (self.flops + self.vector_ops) / max(self.bytes_accessed, 1.0)

    def report(self, peaks: Optional[Dict[str, float]]) -> Dict:
        """Time and achieved rates; with ``peaks``, also each roof's share
        and the binding roof. ``peaks=None`` (a device not in ``PEAKS``)
        reports no share at all."""
        if not np.isfinite(self.seconds) or self.seconds <= 0:
            # measure_amortized could not resolve the kernel above the
            # dispatch noise floor: publish the fact, never a fake number
            return {"kernel": self.name, "invalid":
                    "kernel too fast to resolve above dispatch noise",
                    "notes": self.notes}
        bw = self.bytes_accessed / self.seconds / 1e9
        tc = self.flops / self.seconds / 1e12
        vec = self.vector_ops / self.seconds / 1e12
        out = {
            "kernel": self.name,
            "time_ms": self.seconds * 1e3,
            "bytes": self.bytes_accessed,
            "achieved_gbps": bw,
            "achieved_tc_tflops": tc,
            "achieved_fp32_tops": vec,
            "arithmetic_intensity": self.arithmetic_intensity,
            "notes": self.notes,
        }
        if peaks is None:
            out["roofline"] = "no published peaks for this device"
            return out
        fracs = {
            "hbm": bw / peaks["hbm_gbps"],
            "tensor_core_bf16": tc / peaks["tc_tflops_bf16"],
            "fp32": vec / peaks["fp32_tflops"],
        }
        bound = max(fracs.items(), key=lambda kv: kv[1])
        if bound[1] > 1.0:
            # >100% of a hardware roof is by definition a measurement failure
            return {"kernel": self.name, "invalid":
                    f"measured {100.0 * bound[1]:.0f}% of {bound[0]} peak — "
                    "impossible; timing below the resolvable floor",
                    "time_ms": self.seconds * 1e3, "notes": self.notes}
        out.update({f"pct_{k}_peak": 100.0 * v for k, v in fracs.items()})
        out["binding_roof"] = bound[0]
        out["pct_of_binding_roof"] = 100.0 * bound[1]
        return out


def measure(fn: Callable, args, n: int = 5) -> float:
    """Median wall-clock of fn(*args) with full blocking (post-warmup).

    Includes one dispatch's launch and synchronisation overhead. Use
    ``measure_amortized`` for kernel-quality numbers.
    """
    out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def measure_amortized(fn: Callable, args, inner: int = 8, n: int = 3,
                      max_inner: int = 512) -> float:
    """Per-invocation seconds of ``fn`` with dispatch overhead removed.

    Runs ``fn`` 1x and ``inner``x inside single jitted ``lax.scan`` loops
    (each iteration's output feeds a negligible perturbation of the next
    iteration's input, so XLA cannot elide or overlap the repeats), times
    both with a host fetch of the result, and reports the slope
    (t_inner - t_1)/(inner - 1).

    Self-validating: dispatch and synchronisation put a fixed overhead and
    its noise on both timings, so a slope taken from an N-x run that is not
    measurably longer than the 1-x run is garbage. If t_N < 1.3 * t_1,
    ``inner`` is raised to ``max_inner`` and the measurement retried once;
    if the margin is still not met the result is ``nan`` — callers must
    treat nan as "too fast to resolve" and refuse to publish a roofline row
    from it.
    """
    import jax.numpy as jnp

    def make(length: int):
        @jax.jit
        def run(*a):
            def body(carry, _):
                perturbed, used = [], False
                for x in a:
                    if not used and hasattr(x, "dtype") and x.dtype == jnp.float32:
                        perturbed.append(x + carry)
                        used = True
                    else:
                        perturbed.append(x)
                out = fn(*perturbed)
                # reduce over EVERY output leaf: a single-element probe would
                # let XLA dead-code-eliminate the rest of the computation
                total = sum(
                    leaf.astype(jnp.float32).sum()
                    for leaf in jax.tree_util.tree_leaves(out)
                )
                return total * 1e-30, None

            c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=length)
            return c

        return run

    one = make(1)
    float(one(*args))  # compile
    while True:
        many = make(inner)
        float(many(*args))  # compile
        t1s, tns = [], []
        for _ in range(n):
            t0 = time.perf_counter(); float(one(*args)); t1s.append(time.perf_counter() - t0)
            t0 = time.perf_counter(); float(many(*args)); tns.append(time.perf_counter() - t0)
        t1, tn = float(np.median(t1s)), float(np.median(tns))
        if tn > 1.3 * t1 and tn > t1:
            return (tn - t1) / (inner - 1)
        if inner >= max_inner:
            return float("nan")
        inner = max_inner


# --------------------------------------------------------------------------
# Analytic work models for the mandated kernels
# --------------------------------------------------------------------------

def sgm_aggregation_model(h: int, w: int, d: int, num_paths: int,
                          seconds: float, itemsize: int = 2) -> RooflinePoint:
    """SGM path aggregation (the CUDA kernel of stereo/sgm_cuda.py).

    Memory is the PROBLEM's lower bound — read the cost volume once, write
    the aggregation once (2 passes x itemsize); the kernel reads the costs
    once per direction and writes one plane per direction, which XLA then
    sums, so pct_of_binding_roof measures distance to speed-of-light, not
    to our own traffic. Compute: per cell per direction ~10 f32 ops (2
    neighbour adds, 5 mins, 1 sub, 1 add) + the D-wide min amortized
    ~1 op/cell.
    """
    cells = h * w * d
    bytes_accessed = 2 * cells * itemsize
    vector_ops = num_paths * cells * 11
    return RooflinePoint(
        name=f"sgm_aggregation_{num_paths}path_{h}x{w}x{d}",
        bytes_accessed=bytes_accessed, flops=0.0, vector_ops=vector_ops,
        seconds=seconds,
        notes="one warp per path; bytes = problem lower bound",
    )


def matching_model(ka: int, kb: int, bits: int, seconds: float) -> RooflinePoint:
    """Descriptor matching as bipolar matmul (features/match.py)."""
    flops = 2.0 * ka * kb * bits
    bytes_accessed = (ka * bits + kb * bits) * 2 + ka * kb * 4
    return RooflinePoint(
        name=f"hamming_matmul_{ka}x{kb}x{bits}",
        bytes_accessed=bytes_accessed, flops=flops, vector_ops=ka * kb * 4,
        seconds=seconds, notes="bipolar bf16 matmul + min/argmin",
    )


def ba_schur_model(w_kf: int, l_lm: int, n_obs: int, gn_iters: int,
                   seconds: float) -> RooflinePoint:
    """Dense-block Schur GN solve (ba/schur.py)."""
    per_iter_flops = (
        n_obs * (2 * 18 * 6 + 2 * 9 * 3 + 2 * 18 * 3 + 18 + 9)  # JtJ blocks
        + l_lm * 40                                # 3x3 inverses
        + w_kf * l_lm * (2 * 18 * 3 + 2 * 18 * 6 * w_kf / max(w_kf, 1))
        + w_kf * l_lm * 6 * 3 * 6 * w_kf * 2       # S coupling einsum
        + (6 * w_kf) ** 3 / 3                      # Cholesky
    )
    flops = gn_iters * per_iter_flops
    bytes_accessed = gn_iters * (
        n_obs * (4 * 3 * 3 + 4 * 2) + w_kf * l_lm * 18 * 4 * 3 + l_lm * 9 * 4 * 2
    )
    return RooflinePoint(
        name=f"ba_schur_w{w_kf}_l{l_lm}_n{n_obs}_it{gn_iters}",
        bytes_accessed=bytes_accessed, flops=flops, vector_ops=0.0,
        seconds=seconds, notes="dense-block Schur: einsum assembly + Cholesky",
    )


def voxel_model(n_points: int, seconds: float) -> RooflinePoint:
    """Sort + segment-reduce voxel filter (mapping/voxel.py)."""
    log_n = max(1.0, np.log2(max(n_points, 2)))
    bytes_accessed = n_points * 4 * (2 * log_n * 0.5 + 10)
    return RooflinePoint(
        name=f"voxel_downsample_{n_points}",
        bytes_accessed=bytes_accessed, flops=0.0,
        vector_ops=n_points * log_n * 4,
        seconds=seconds, notes="two stable sorts dominate",
    )
