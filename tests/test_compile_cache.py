"""The entry points' compile cache (utils/compile_cache.py): where it goes,
and that a second process finds what the first compiled.

Each case runs the probe below in fresh interpreters, as an entry point
would be run, because JAX fixes its cache directory at the first compile.
"""

import os
import subprocess
import sys
import textwrap
import uuid

from online_3d_reconstruction.utils.compile_cache import CHECKOUT

PROBE = textwrap.dedent("""
    import sys

    import jax
    import jax.numpy as jnp
    from jax import monitoring

    from online_3d_reconstruction.utils.compile_cache import enable_compile_cache

    hits = []
    monitoring.register_event_listener(
        lambda event, **_: hits.append(event)
        if event == "/jax/compilation_cache/cache_hits" else None)
    print(enable_compile_cache())
    salt = float(sys.argv[1])   # a constant of the program: a new program per test
    x = jax.block_until_ready(jnp.ones(3))
    hits.clear()                # count the salted program's hit alone
    jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) * salt)(x))
    print(len(hits))
""")


def _probe(salt: float, cache_dir=None):
    env = dict(os.environ, PYTHONPATH=CHECKOUT, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if cache_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(cache_dir)
    out = subprocess.run([sys.executable, "-c", PROBE, repr(salt)], env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    path, hits = out.stdout.split()
    return path, int(hits)


def _salt() -> float:
    return 1.0 + uuid.uuid4().int % 10**6 / 10**7


def test_unset_variable_caches_in_checkout_and_second_run_hits():
    salt = _salt()
    assert _probe(salt) == (os.path.join(CHECKOUT, ".jax_cache"), 0)
    assert _probe(salt) == (os.path.join(CHECKOUT, ".jax_cache"), 1)


def test_set_variable_is_the_cache_directory(tmp_path):
    salt = _salt()
    assert _probe(salt, tmp_path) == (str(tmp_path), 0)
    assert os.listdir(tmp_path), "nothing cached in JAX_COMPILATION_CACHE_DIR"
    assert _probe(salt, tmp_path) == (str(tmp_path), 1)
