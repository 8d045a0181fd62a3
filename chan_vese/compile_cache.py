"""Persistent XLA compilation cache: one fixed place per checkout.

Compiling the 4K programs takes seconds to minutes, and a process that
starts cold pays it again. JAX keeps compiled executables across processes
in the directory named by ``jax_compilation_cache_dir``. The directory's
path is part of the cache key, so it must not move between runs: when the
environment names one (``JAX_COMPILATION_CACHE_DIR``, which JAX reads
itself) that one is used and nothing is set here; otherwise the cache goes
to ``<checkout>/.jax_cache``, which ``.gitignore`` lists.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache(environ=None) -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return that directory. Call before the first compilation."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_VAR):
        return environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
