"""JAX's persistent compilation cache, for the entry points.

Entry points (``bench.py``, ``chip_smoke.py``, ``apps/*.py``, ``tools/*``
and the test suite) call ``enable_compile_cache`` before their first
compile. Library modules never do: importing the package changes no JAX
setting.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Cache compiled programs where ``JAX_COMPILATION_CACHE_DIR`` says
    (JAX reads that variable itself) or, where it is unset, in the fixed
    directory ``<checkout>/.jax_cache``, so that a second run of the same
    program in the same checkout skips its compiles. Every program is
    cached, however fast it compiled. Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
