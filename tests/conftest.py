"""Test configuration.  With JAX_PLATFORMS unset or "cpu" the suite runs
on the CPU backend with 8 virtual devices (the multi-device mesh tests
need them) and float64 enabled for the golden-value physics tests; any
other JAX_PLATFORMS value (e.g. "cuda" for the card tests, `-m gpu`) is
respected.  Must run before jax is imported anywhere."""

import os
import sys

_platforms = os.environ.get("JAX_PLATFORMS", "")
ON_CPU = _platforms in ("", "cpu")
if ON_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
os.environ["JAX_ENABLE_X64"] = "1"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: repeated pytest runs skip recompiling the
# big dense-energy graphs.  JAX_COMPILATION_CACHE_DIR, when set, wins (JAX
# reads it itself); otherwise MMC_TEST_CACHE or tests/.jax_cache.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", os.environ.get(
        "MMC_TEST_CACHE",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".jax_cache")))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import pytest  # noqa: E402

# NIST SPC/E sample configurations and the other upstream input files are
# not part of this repository; tests that need them skip until they are
# placed here (or MMC_REFERENCE_DIR points at a copy).
REFERENCE_DIR = os.environ.get("MMC_REFERENCE_DIR",
                               os.path.join(REPO, "reference"))


@pytest.fixture(scope="session")
def reference_dir():
    if not os.path.isdir(REFERENCE_DIR):
        pytest.skip("reference data not available")
    return REFERENCE_DIR


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips when the backend has none (the
    default CPU test run)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a CUDA device: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
    return gpus[0]
