"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR (or a directory
the process already configured) wins; otherwise one fixed, git-ignored
path inside the checkout."""

import os

import jax
import pytest

from metropolismontecarlo_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cache_dir(monkeypatch):
    """Run with the cache directory unset, restoring it afterwards."""
    saved = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_variable_wins(no_cache_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None   # set nothing


def test_configured_directory_is_kept(no_cache_dir, tmp_path):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_is_fixed_ignored_repo_path(no_cache_dir):
    got = cache.enable_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    assert not got.startswith("/tmp")
