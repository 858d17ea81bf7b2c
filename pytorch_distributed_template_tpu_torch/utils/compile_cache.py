"""The compile cache of the port (the counterpart of the JAX package's
``utils/compile_cache.py``).

The JAX package's persistent artifacts are XLA executables in the
directory that a config's ``compile_cache.dir`` names. The port's are the
kernel libraries that ``ops/build.py`` builds with ``nvcc``: one
``lib<name>-<digest>.so`` per CUDA source in ``build/kernels/`` beside the
package, keyed by the sha256 of the source and its headers, so an edited
source is rebuilt and a built one is reused by every later process. That
directory stays where it is: a checkout builds from its own sources.

:func:`configure_compile_cache` reads the config's ``compile_cache``
section as the JAX function does and says in the log that the XLA
directory has no use in the port; :func:`compile_cache_stats` reports the
kernel libraries (entries, bytes, and the process's hits and misses).
"""
from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger(__name__)


def configure_compile_cache(config=None) -> Optional[str]:
    """Log what the config's ``compile_cache`` section means for the port
    and return the port's cache directory (the kernel libraries'), which
    exists whatever the config says. Never raises."""
    from ..ops import build

    section = {}
    if config is not None:
        try:
            section = dict(config.get("compile_cache", None) or {})
        except Exception:  # noqa: BLE001 — never fail an entry point
            section = {}
    if section.get("dir") and section.get("enabled", True):
        logger.info(
            "compile_cache.dir %s is an XLA compilation cache and has no "
            "use in the port; its compiled artifacts are the kernel "
            "libraries in %s", section["dir"], build.BUILD_DIR)
    return str(build.BUILD_DIR)


def compile_cache_stats() -> dict:
    """``{"enabled", "dir", "entries", "bytes", "hits", "misses"}``: the
    built kernel libraries on disk and this process's loads of them (a
    hit found the library built, a miss built it)."""
    from ..ops import build

    libs = sorted(build.BUILD_DIR.glob("lib*.so")) \
        if build.BUILD_DIR.is_dir() else []
    return {"enabled": True, "dir": str(build.BUILD_DIR),
            "entries": len(libs),
            "bytes": sum(p.stat().st_size for p in libs),
            **build.cache_counters()}
