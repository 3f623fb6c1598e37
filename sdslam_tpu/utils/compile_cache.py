"""Where the persistent XLA compile cache lives, for every entry point.

`JAX_COMPILATION_CACHE_DIR`, when set, is the cache and no other directory
is configured. Otherwise the cache is one fixed directory inside the
checkout, `.jax_cache/` (listed in .gitignore): a cache directory is part
of the cache key, so a path that moved between runs would never hit.
`SDSLAM_JAX_CACHE=0` turns the cache off (the test suite does, because the
setting is process-global).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def cache_dir() -> Optional[str]:
    """The directory the cache would use, or None when it is switched off."""
    if os.environ.get("SDSLAM_JAX_CACHE") == "0":
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable() -> Optional[str]:
    """Point JAX's persistent compile cache at `cache_dir()`; returns it."""
    path = cache_dir()
    if path is None:
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
