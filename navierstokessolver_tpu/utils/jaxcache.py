"""Persistent-compilation-cache setup shared by every entry point.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when that is set;
otherwise at the fixed ``<checkout>/.jax_cache`` (listed in .gitignore).
The path is part of what makes a later process find an entry, so it is
never derived from a temp directory, a pid or the clock.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def setup() -> str:
    """Enable the on-disk executable cache at :func:`cache_dir`; returns it.

    Entries are zlib-compressed: the ``zstandard`` extension has crashed
    on large executables, and a torn entry then crashes every later
    reader, so every writer disables it before its first compile.
    """
    import jax
    from jax._src import compilation_cache as _cc

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _cc.zstandard = None
    return path
