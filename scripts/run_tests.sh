#!/usr/bin/env bash
# Full-suite runner, SHARDED across processes.
#
# Why: running all ~220 tests in ONE process segfaults reproducibly
# after ~170 tests inside XLA:CPU's native executable serialize/
# deserialize (the persistent-cache read/write path) — an upstream
# XLA:CPU AOT issue that individual files never hit (observed 4x on
# this box, at slightly drifting positions, with both fresh and warm
# caches).  Three ~70-test processes stay far below the threshold.
# Each shard gets its OWN persistent cache dir: concurrent/interleaved
# writers to one cache dir can corrupt entries (see tests/conftest.py).
set -u
cd "$(dirname "$0")/.."
fail=0
shard() {
    name="$1"; shift
    echo "=== shard $name: $* ==="
    MMC_TEST_CACHE="tests/.jax_cache_$name" \
        python -m pytest "$@" -q || fail=1
}
shard a tests/test_fep.py tests/test_gcmc.py tests/test_gcmc_binary.py \
    tests/test_gcmc_mol.py tests/test_gcmc_osmotic.py \
    tests/test_gibbs.py tests/test_gibbs_binary.py \
    tests/test_gibbs_mol.py tests/test_io_observables.py \
    tests/test_cache.py tests/test_chip_smoke.py
shard b tests/test_linear.py tests/test_lrc_exchange.py \
    tests/test_mbar.py tests/test_mc.py \
    tests/test_mixture.py tests/test_nist_golden.py tests/test_ops.py \
    tests/test_reference.py tests/test_configs.py
shard c tests/test_parallel.py tests/test_polyatomic.py \
    tests/test_semigrand.py tests/test_tip4p.py \
    tests/test_tmmc.py tests/test_tmmc_mol.py tests/test_topology.py \
    tests/test_widom.py tests/test_wolf_ref_surface.py \
    tests/test_wolf_vs_ewald_rdf.py tests/test_trace.py tests/test_gpu.py
exit $fail
