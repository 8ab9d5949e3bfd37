"""The persistent XLA compilation cache, set up in one place.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; where it is set, no other
directory is configured here. Otherwise the cache lives at the fixed
`<repo>/.jax_cache` (listed in .gitignore), so repeated runs of the CLI,
the benchmark, the tests and chip_smoke.py replay their compiles.
"""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_REPO, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
