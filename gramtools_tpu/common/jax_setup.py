"""JAX runtime configuration helpers."""
from __future__ import annotations

import os
from pathlib import Path

# the directory above the package: a checkout when pyproject.toml sits
# there, a Python lib directory when the package is installed
_ROOT = Path(__file__).resolve().parents[2]


def compile_cache_dir() -> Path | None:
    """The directory this program sets for JAX's persistent compile
    cache: the fixed ``<checkout>/.jax_cache`` (listed in .gitignore; a
    fixed path, because a moving directory never hits). None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself) or when the
    package runs from an install rather than a checkout (caching is then
    left to that variable)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if not (_ROOT / "pyproject.toml").is_file():
        return None
    return _ROOT / ".jax_cache"


def enable_compile_cache():
    """Persistent XLA compile cache: the scan and record programs compile
    once per (shape, config) per machine instead of once per process."""
    import jax

    cache_dir = compile_cache_dir()
    if cache_dir is not None:
        cache_dir.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
