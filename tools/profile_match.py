"""Decompose the descriptor-matching kernel's time on the device.

This measures each piece — bit unpack, the bipolar matmul itself, top-2,
cross-check argmin, and the assembled match_descriptors — to establish
whether the gap is the matmul (fixable) or the fixed cost of the top-k /
small-op sequence (a floor at this problem size).

Usage: python tools/profile_match.py   (from the repo root)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from online_3d_reconstruction.features.match import (
    _unpack_bipolar,
    hamming_matrix,
    match_descriptors,
)
from online_3d_reconstruction.utils.roofline import measure_amortized


from online_3d_reconstruction.utils.compile_cache import enable_compile_cache  # noqa: E402

def main():
    enable_compile_cache()
    print("backend:", jax.default_backend(), flush=True)
    ka = kb = 512
    rng = np.random.default_rng(0)
    desc_a = jnp.asarray(rng.integers(0, 2**32, (ka, 8), dtype=np.uint32))
    desc_b = jnp.asarray(rng.integers(0, 2**32, (kb, 8), dtype=np.uint32))
    va = jnp.ones(ka, bool)

    def report(name, sec):
        print(f"{name:44s} {sec * 1e6:9.1f} us", flush=True)

    sec = measure_amortized(
        lambda eps, d: _unpack_bipolar((d.astype(jnp.float32) + eps)
                                       .astype(jnp.uint32)),
        (jnp.float32(0.0), desc_a), inner=64)
    report("unpack bipolar (512x256)", sec)

    a = _unpack_bipolar(desc_a)
    b = _unpack_bipolar(desc_b)

    sec = measure_amortized(
        lambda eps, aa: jnp.dot(aa + eps, b.T,
                                preferred_element_type=jnp.float32),
        (jnp.float32(0.0), a.astype(jnp.float32)), inner=64)
    report("bipolar matmul 512x512x256 (f32 in)", sec)

    sec = measure_amortized(
        lambda eps, d: hamming_matrix(
            (d.astype(jnp.float32) + eps).astype(jnp.uint32), desc_b, va, va),
        (jnp.float32(0.0), desc_a), inner=64)
    report("hamming_matrix (unpack+mm+mask)", sec)

    dist = hamming_matrix(desc_a, desc_b, va, va)

    sec = measure_amortized(
        lambda eps, dd: jax.lax.top_k(-(dd + eps), 2),
        (jnp.float32(0.0), dist), inner=64)
    report("top_k(2) over 512x512", sec)

    sec = measure_amortized(
        lambda eps, dd: jnp.argmin(dd + eps, axis=0),
        (jnp.float32(0.0), dist), inner=64)
    report("argmin axis=0 (cross-check)", sec)

    sec = measure_amortized(
        lambda eps, d: match_descriptors(
            (d.astype(jnp.float32) + eps).astype(jnp.uint32), desc_b, va, va),
        (jnp.float32(0.0), desc_a), inner=64)
    report("FULL match_descriptors", sec)


if __name__ == "__main__":
    main()
