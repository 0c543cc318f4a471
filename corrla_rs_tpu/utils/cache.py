"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and the
cache lives there. Otherwise it lives inside the checkout, in
``.jax_cache/<tag>`` (listed in ``.gitignore``), where ``<tag>`` hashes the
JAX version and the host CPU's feature flags: XLA:CPU stores machine code,
and an entry compiled for CPU features this host lacks could crash when
loaded, so a cache written on another host is never seen here.
"""
from __future__ import annotations

import hashlib
import os

import jax

__all__ = ["enable_persistent_cache", "cache_dir", "host_feature_tag"]

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def host_feature_tag() -> str:
    """Short hash of (jax version, host CPU feature flags).

    Reads the first ``flags`` line of /proc/cpuinfo (Linux). On platforms
    without it, falls back to ``platform.machine()`` so the tag still
    separates architectures.
    """
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        import platform

        flags = platform.machine()
    h = hashlib.sha256(f"{jax.__version__}|{flags}".encode()).hexdigest()
    return h[:12]


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache/<tag>``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(_CHECKOUT, ".jax_cache", host_feature_tag())


def enable_persistent_cache() -> None:
    jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.05)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
