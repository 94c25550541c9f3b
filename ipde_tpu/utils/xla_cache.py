"""Persistent XLA compilation cache.

JAX's persistent cache writes every compiled executable to disk keyed by
(HLO, platform, flags), so a later process that compiles the same program
loads it instead.  The directory is part of what a later process must find,
so it never comes from a tempdir, a uid, a pid or the clock:

  JAX_COMPILATION_CACHE_DIR set   JAX reads it itself; nothing is set here
  IPDE_XLA_CACHE=0                disable
  IPDE_XLA_CACHE=<dir>            cache directory override
  (otherwise)                     <checkout>/.jax_cache (in .gitignore)

Executables are code, so the directory is created 0700 and refused when
another user owns it or it is group/world-writable.

enable_persistent_cache() is idempotent and cheap; it is called from the
heavy setup entry points (EmbeddedBoundary constructor) rather than at
import so plain library imports never touch jax.config.
"""

from __future__ import annotations

import os
import stat

_DONE = False


def default_dir() -> str:
    """<checkout>/.jax_cache: fixed, inside the repository."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def _dir_is_safe(path: str) -> bool:
    try:
        st = os.stat(path)
    except OSError:
        return False
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        return False
    return not (st.st_mode & (stat.S_IWGRP | stat.S_IWOTH))


def enable_persistent_cache() -> bool:
    """Idempotently point jax at the on-disk compilation cache.  Returns
    True when the cache is active."""
    global _DONE
    if _DONE or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return True
    flag = os.environ.get("IPDE_XLA_CACHE", "").strip()
    if flag in ("0", "off", "false", "no"):
        return False
    cache_dir = flag or default_dir()
    try:
        os.makedirs(cache_dir, mode=0o700, exist_ok=True)
    except OSError:
        return False
    if not _dir_is_safe(cache_dir):
        return False
    import jax
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    _DONE = True
    return True
