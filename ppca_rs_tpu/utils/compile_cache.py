"""Persistent XLA compilation cache for the entry scripts.

JAX keys its on-disk cache by the directory it lives in, so the directory
has to stay put from one run to the next.  When ``JAX_COMPILATION_CACHE_DIR``
is set, JAX already reads it and nothing here overrides it; otherwise the
cache goes to ``.jax_cache/`` at the root of the checkout.
"""

from __future__ import annotations

import os

import jax

#: ``.jax_cache/`` beside the package directory (the checkout root).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
