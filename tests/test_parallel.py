"""Multi-device tests on the 8-virtual-CPU-device mesh: sharded sweeps
match unsharded bit-for-bit, REMC ladders order energies by temperature,
and the incremental Ewald state survives exchanges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.monatomic import lj_box_for_density, lj_system
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system
from metropolismontecarlo_tpu.parallel.mesh import make_mesh, shard_state
from metropolismontecarlo_tpu.parallel.remc import exchange, temperature_ladder


def _tiny_water_mc(n_chains, dtype=jnp.float32):
    system = spce_system(8)
    params = RunParams(temperature=300.0, r_cut=5.0, cutoff_mode="site",
                       coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
                       dr_max=0.3, dphi_max=0.4)
    mc = MonteCarlo(system, params, dtype=dtype, recompute_chunk=4)
    state = mc.init_state(jax.random.PRNGKey(0), cubic_lattice(8, 12.0),
                          box=12.0, n_chains=n_chains)
    return mc, state


def test_mesh_uses_8_devices():
    mesh = make_mesh(8)
    assert mesh.size == 8


def test_make_mesh_raises_without_enough_devices():
    """Asking for more devices than the backend has is an error; no other
    platform's devices are substituted."""
    with pytest.raises(ValueError, match="16 devices requested"):
        make_mesh(16)


def test_make_mesh_2d_raises_without_enough_devices():
    from metropolismontecarlo_tpu.parallel.tp import make_mesh_2d

    with pytest.raises(ValueError, match="needs 12 devices"):
        make_mesh_2d(3, 4)
    assert make_mesh_2d(2, 4).devices.shape == (2, 4)


def test_sharded_sweep_matches_unsharded():
    mc, state = _tiny_water_mc(16)
    ref = mc.run_steps(state, 2, False)

    mesh = make_mesh(8)
    sstate = shard_state(state, mesh)
    out = mc.run_steps(sstate, 2, False)
    np.testing.assert_allclose(np.asarray(out.energy), np.asarray(ref.energy),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(out.acc), np.asarray(ref.acc))


def test_remc_orders_energy_by_temperature():
    """LJ replica ladder: after exchanges + sampling, mean energy must be
    monotone-ish in temperature and swaps must actually occur."""
    n, rho = 27, 0.5
    box = lj_box_for_density(n, rho)
    system = lj_system(n)
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=0.4,
                       use_lrc=False)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=8)
    C = 8
    state = mc.init_state(jax.random.PRNGKey(2), cubic_lattice(n, box),
                          box=box, n_chains=C)
    ladder = temperature_ladder(0.8, 2.4, C, dtype=jnp.float64)
    state = state._replace(temp=ladder)

    fracs = []
    e_by_t = np.zeros(C)
    n_rounds = 60
    for r in range(n_rounds):
        state = mc.run_steps(state, 3, False)
        state, frac = exchange(state, jax.random.fold_in(jax.random.PRNGKey(9), r),
                               phase=r % 2)
        fracs.append(float(frac))
        if r >= n_rounds // 2:
            e_by_t += np.asarray(state.energy)
    e_by_t /= n_rounds / 2
    mean_frac = np.mean(fracs)
    assert 0.05 < mean_frac <= 1.0, mean_frac
    # energies at the coldest vs hottest rungs must separate clearly
    assert e_by_t[0] < e_by_t[-1] - 5.0, e_by_t
    # temperatures stayed attached to slots
    np.testing.assert_allclose(np.asarray(state.temp), np.asarray(ladder))


def test_remc_preserves_ewald_consistency():
    """After configuration swaps, carried structure factors must still
    match a full recompute (they swap with the configuration)."""
    mc, state = _tiny_water_mc(8, dtype=jnp.float64)
    ladder = temperature_ladder(280.0, 400.0, 8, dtype=jnp.float64)
    state = state._replace(temp=ladder)
    state = mc.run_steps(state, 3, False)
    state, _ = exchange(state, jax.random.PRNGKey(11), 0)
    state = mc.run_steps(state, 3, False)
    e, w, sfac = mc.full_energy(state)
    np.testing.assert_allclose(np.asarray(e), np.asarray(state.energy),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(sfac), np.asarray(state.sfac),
                               rtol=1e-8, atol=1e-10)


def test_shard_map_run_steps_matches_unsharded():
    """Explicit shard_map execution (each device advances its own chains)
    must reproduce the unsharded run bitwise."""
    from metropolismontecarlo_tpu.parallel.mesh import sharded_run_steps

    mc, state = _tiny_water_mc(16)
    ref = mc.run_steps(state, 2, False)
    mesh = make_mesh(8)
    out = sharded_run_steps(mc, state, mesh, 2, False)
    np.testing.assert_array_equal(np.asarray(out.energy), np.asarray(ref.energy))
    np.testing.assert_array_equal(np.asarray(out.coords), np.asarray(ref.coords))
    np.testing.assert_array_equal(np.asarray(out.acc), np.asarray(ref.acc))


def test_sharded_remc_matches_unsharded():
    """REMC inside shard_map — cross-device partner traffic as explicit
    ppermute edge swaps — must reproduce the unsharded sweep+exchange
    sequence bitwise, including swap fractions, across both phases (odd
    phase pairs straddle device boundaries with 2 local chains/device)."""
    from metropolismontecarlo_tpu.parallel.mesh import sharded_run_steps

    mc, state = _tiny_water_mc(16)
    ladder = temperature_ladder(250.0, 500.0, 16, dtype=state.temp.dtype)
    state = state._replace(temp=ladder)
    xkey = jax.random.PRNGKey(21)

    # reference: unsharded sweeps + unsharded exchange, phases 0 then 1
    ref = state
    ref_fracs = []
    for r in range(2):
        ref = mc.run_steps(ref, 2, False)
        ref, frac = exchange(ref, jax.random.fold_in(xkey, r), r % 2)
        ref_fracs.append(float(frac))

    mesh = make_mesh(8)
    out, fracs = sharded_run_steps(mc, state, mesh, 4, False,
                                   remc_every=2, remc_key=xkey, phase0=0)
    np.testing.assert_array_equal(np.asarray(out.energy),
                                  np.asarray(ref.energy))
    np.testing.assert_array_equal(np.asarray(out.coords),
                                  np.asarray(ref.coords))
    np.testing.assert_array_equal(np.asarray(out.sfac), np.asarray(ref.sfac))
    np.testing.assert_allclose(np.asarray(fracs), np.asarray(ref_fracs),
                               rtol=1e-6)
    # the wide ladder must actually discriminate: some swap rejected
    # somewhere would show frac < 1; at minimum swaps occurred
    assert np.all(np.asarray(fracs) > 0.0)


def test_tp_full_energy_matches_unsharded():
    """2x4 (chains x atoms) mesh: the tensor-parallel recompute —
    row-sharded pair tiles + psum'd S(k)/recip contractions — must match
    the single-device full_energy to roundoff (f64)."""
    from metropolismontecarlo_tpu.parallel.tp import (
        make_mesh_2d, tp_full_energy_fn)

    system = spce_system(9)   # 27 atoms: NOT divisible by block*shards
    params = RunParams(temperature=300.0, r_cut=5.0, cutoff_mode="site",
                       coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
                       dr_max=0.3, dphi_max=0.4)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=2)
    state = mc.init_state(jax.random.PRNGKey(3), cubic_lattice(9, 12.5),
                          box=12.5, n_chains=4)
    state = mc.run_steps(state, 2, False)   # de-lattice a bit

    e_ref, w_ref, sfac_ref = mc.full_energy(state)

    mesh = make_mesh_2d(2, 4)
    fn = tp_full_energy_fn(system, params, mesh, mc.kvecs, mc.kweights,
                           recompute_chunk=2, row_block=8)
    e, w, sfac = fn(state.coords, state.com, state.box)
    np.testing.assert_allclose(np.asarray(e), np.asarray(e_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(sfac), np.asarray(sfac_ref),
                               rtol=1e-10, atol=1e-12)


def test_tp_full_energy_wolf_lj():
    """TP recompute on a charge-free LJ system exercises the no-coulomb
    assembly path under the atoms axis."""
    from metropolismontecarlo_tpu.parallel.tp import (
        make_mesh_2d, tp_full_energy_fn)

    n, rho = 27, 0.6
    box = lj_box_for_density(n, rho)
    params = RunParams(strict_min_image=False, temperature=1.2, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=0.15)
    mc = MonteCarlo(lj_system(n), params, dtype=jnp.float64)
    state = mc.init_state(jax.random.PRNGKey(5), cubic_lattice(n, box),
                          box=box, n_chains=8)
    state = mc.run_steps(state, 2, False)
    e_ref, w_ref, _ = mc.full_energy(state)

    mesh = make_mesh_2d(4, 2)
    fn = tp_full_energy_fn(mc.system, params, mesh, recompute_chunk=1,
                           row_block=8)
    e, w, _ = fn(state.coords, state.com, state.box)
    np.testing.assert_allclose(np.asarray(e), np.asarray(e_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref), rtol=1e-10)


def test_driver_tp_mesh_run_block():
    """MonteCarlo(tp_mesh=...) integration: a full block (sweeps +
    TP-sharded drift recompute) agrees with the accumulated energies."""
    from metropolismontecarlo_tpu.parallel.tp import make_mesh_2d

    system = spce_system(8)
    params = RunParams(temperature=300.0, r_cut=5.0, cutoff_mode="site",
                       coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
                       dr_max=0.3, dphi_max=0.4)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=2,
                    tp_mesh=make_mesh_2d(2, 4))
    state = mc.init_state(jax.random.PRNGKey(0), cubic_lattice(8, 12.0),
                          box=12.0, n_chains=4)
    state, stats = mc.run_block(state, 2)
    assert float(stats["drift_max_rel"]) < 1e-10
