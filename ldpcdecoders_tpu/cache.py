"""Persistent XLA compilation cache helper.

The staged circuit-level decoder alone compiles one program per bucket
width and leg kind; the persistent cache keeps compiled programs across
processes.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses that
directory and this module sets no other.  Otherwise the cache lives in
the checkout's ``.jax_cache`` (a fixed path: the path is part of the
cache key, so a directory that moves never hits).  The first decode
through the base API or the parallel helpers enables it automatically
(opt out with ``LDPC_JAX_CACHE=off``); :func:`enable_compilation_cache`
is the explicit entry point.
"""

from __future__ import annotations

import os

__all__ = ["enable_compilation_cache"]

_configured = False
_ENV_DIR = "JAX_COMPILATION_CACHE_DIR"
#: ``<checkout>/.jax_cache``
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _opted_out() -> bool:
    return os.environ.get("LDPC_JAX_CACHE", "").lower() in ("0", "off", "none")


def ensure_default_cache() -> None:
    """Idempotently enable the persistent cache with default settings.

    Called from ``Decoder._call_decode`` (the first decode through the
    base API) and the ``parallel`` entry points.  Skipped when
    ``LDPC_JAX_CACHE`` is ``0``/``off``/``none``, when a cache directory
    is already configured (``JAX_COMPILATION_CACHE_DIR`` or the
    application's own ``jax_compilation_cache_dir``), and on the CPU.
    """
    global _configured
    if _configured:
        return
    _configured = True
    if _opted_out():
        return
    import jax

    if getattr(jax.config, "jax_compilation_cache_dir", None):
        return  # respect an outside configuration
    if jax.default_backend() == "cpu":
        # CPU compiles are seconds, and XLA:CPU's AOT loader warns
        # ("could lead to SIGILL") whenever it reloads a cached
        # executable, because compile-side tuning flags like
        # +prefer-no-gather are never listed as host features — even on
        # the very machine that compiled it.  Call
        # enable_compilation_cache() to force it.
        return
    enable_compilation_cache()


def enable_compilation_cache(cache_dir: str | None = None) -> str | None:
    """Point JAX's persistent compilation cache at a directory.

    ``JAX_COMPILATION_CACHE_DIR``, where set, always wins: it is the
    directory used, and none other is set.  Otherwise ``cache_dir`` is
    used verbatim, defaulting to the checkout's ``.jax_cache``.  The
    opt-out sentinels ``LDPC_JAX_CACHE=0|off|none`` disable caching here
    too (so CLI/bench entry points honor them) and return None.
    Returns the directory used, or None if disabled or configuration
    failed (read-only filesystem, ...).
    """
    import jax

    if _opted_out():
        return None
    env = os.environ.get(_ENV_DIR)
    if env:
        if jax.config.jax_compilation_cache_dir != env:
            jax.config.update("jax_compilation_cache_dir", env)
        return env
    cache_dir = cache_dir or DEFAULT_DIR
    try:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        return cache_dir
    except Exception:
        return None
