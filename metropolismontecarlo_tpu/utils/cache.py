"""Persistent XLA compilation cache, placed from outside or at one fixed
path.

When `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets no directory; a directory the process already configured is
kept as well.  Otherwise the cache lives at `<repo>/.jax_cache`
(git-ignored): a fixed path, so a later process on the same checkout finds
the entries again.
"""

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache():
    """Turn the persistent cache on; returns the directory in use."""
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    current = os.environ.get("JAX_COMPILATION_CACHE_DIR") \
        or jax.config.jax_compilation_cache_dir
    if current:
        return current
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
