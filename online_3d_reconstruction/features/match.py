"""Descriptor matching as a batched matmul + top-2.

The reference brute-force-matches binary descriptors with
``cv::cuda::DescriptorMatcher`` (Hamming) (SURVEY.md §2.1 C8, §3.3 — the N^2
hot loop). North star mandate: "brute-force descriptor matching -> batched
matmul top-k".

Identity used: for bipolar vectors a, b in {-1,+1}^B,
    Hamming(a, b) = (B - a.b) / 2
so the full N x M Hamming matrix is one (N, B) x (B, M) matmul.
Descriptors are unpacked from uint32 words to bf16 bipolar form (dot products
of +/-1 vectors are integers <= B = exactly representable; accumulation is
fp32 via preferred_element_type). Ratio test + mutual cross-check are fused
elementwise ops on the distance matrix. All shapes static; invalid slots are
driven to +inf distance.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_INF = jnp.float32(1e9)


class Matches(NamedTuple):
    """Fixed-capacity match set: one slot per query keypoint."""

    index: jnp.ndarray     # (K,) int32 — matched train keypoint per query
    distance: jnp.ndarray  # (K,) float32 — Hamming distance
    valid: jnp.ndarray     # (K,) bool — passed ratio/threshold/cross checks


def _unpack_bipolar(descriptors: jnp.ndarray) -> jnp.ndarray:
    """(K, W) uint32 packed bits -> (K, W*32) bf16 in {-1, +1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (descriptors[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    k = descriptors.shape[0]
    bits = bits.reshape(k, -1).astype(jnp.float32)
    return (bits * 2.0 - 1.0).astype(jnp.bfloat16)


@jax.jit
def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray,
                   valid_a: jnp.ndarray, valid_b: jnp.ndarray) -> jnp.ndarray:
    """(Ka, Kb) float32 Hamming distances; invalid rows/cols get +inf."""
    bits = desc_a.shape[1] * 32
    a = _unpack_bipolar(desc_a)
    b = _unpack_bipolar(desc_b)
    dot = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    dist = 0.5 * (bits - dot)
    dist = jnp.where(valid_a[:, None] & valid_b[None, :], dist, _INF)
    return dist


@partial(jax.jit, static_argnames=("max_hamming", "ratio", "cross_check"))
def match_descriptors(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
    max_hamming: int = 64,
    ratio: float = 0.9,
    cross_check: bool = True,
) -> Matches:
    """Match every query (a) descriptor against all train (b) descriptors.

    Equivalent of BFMatcher.knnMatch(k=2) + Lowe ratio + crossCheck, as one
    matmul and a handful of reductions.
    """
    dist = hamming_matrix(desc_a, desc_b, valid_a, valid_b)

    # top-2 along the train axis for the ratio test — as min/argmin/masked-min
    # passes, NOT lax.top_k: top_k lowers to a per-row sort, while three
    # fused reductions cost ~bandwidth only (the sort was the slower one on
    # the earlier accelerator target; not yet measured on the H100)
    best = jnp.min(dist, axis=1)
    best_idx = jnp.argmin(dist, axis=1)
    cols = jnp.arange(dist.shape[1], dtype=jnp.int32)
    second = jnp.min(jnp.where(cols[None, :] == best_idx[:, None], _INF, dist),
                     axis=1)

    ok = valid_a & (best <= max_hamming) & (best < ratio * second)
    if cross_check:
        back = jnp.argmin(dist, axis=0)        # best query for each train kp
        mutual = back[best_idx] == jnp.arange(dist.shape[0])
        ok = ok & mutual
    return Matches(index=best_idx.astype(jnp.int32), distance=best, valid=ok)
