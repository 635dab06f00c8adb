"""JAX's persistent compilation cache, set up the same way by every entry
point (the CLI, the benchmarks and ``chip_smoke.py``)."""

from __future__ import annotations

import os
from pathlib import Path

import jax

# Fixed, not derived from a temp name, a PID or the time: the directory is
# part of each entry's key, so a cache that moves never hits.
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str | None:
    """Keep compiled programs across processes; returns the directory in
    use, or None when the cache stays off.

    ``JAX_COMPILATION_CACHE_DIR``, when set, names the directory: JAX reads
    it itself and no other directory is set here.  Otherwise the cache goes
    to ``.jax_cache/`` at the checkout root.  On the CPU the cache stays off:
    CPU entries are machine-specific (loading one compiled elsewhere risks
    SIGILL), and CPU compiles are fast anyway."""
    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
