"""
Where JAX keeps its persistent compilation cache — one rule, one place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is the only
cache and nothing here overrides it. Otherwise the cache goes to the
fixed ``.jax_cache/`` directory at the root of the checkout (listed in
``.gitignore``): the path is part of each entry's key, so a directory
that moved between runs would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

#: The in-checkout cache directory used when the variable is unset.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its one directory
    and return that directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
