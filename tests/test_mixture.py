"""Ragged species-blocked storage (mixed TIP4P/2005 + SPC/E): a 3-atom
water next to a 4-atom water owns 3 atom columns, not 4.  These tests pin
the ragged layout against the uniform-width padded representation (which
is exact by construction: pad slots have zero charge/epsilon) and check
the move paths keep the drift invariant on ragged systems.

Reference analogue: the per-molecule arrays of the reference's
mixed-species setup (`Ewald/setup.jl:446-537`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.mixture import mixture_system
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system, tip4p2005_system

PARAMS = RunParams(temperature=298.15, r_cut=6.0, cutoff_mode="site",
                   coulomb="ewald", nk=4, ksq_max=16, p_translate=0.5,
                   dr_max=0.25, dphi_max=0.25)


def _mixture(n_wide=4, n_sol=28):
    """n_wide 4-site TIP4P/2005 molecules, then n_sol 3-site SPC/E."""
    return mixture_system([(tip4p2005_system(1), n_wide),
                           (spce_system(1), n_sol)])


def test_ragged_layout_bookkeeping():
    system = _mixture()
    assert not system.uniform_width
    assert system.n_atoms == 4 * 4 + 28 * 3
    assert [s[:2] for s in system.species] == [("tip4p2005", 4),
                                               ("spce", 28)]
    mol, slot = system.atom_mol_slot
    assert mol.shape == (system.n_atoms,)
    a0 = system.mol_a0
    assert a0[4] == 16 and a0[5] == 19  # first SPC/E after 4 TIP4P
    # flat() drops per-molecule pad slots
    q = system.flat(system.charges)
    assert q.shape == (system.n_atoms,)
    assert abs(float(np.sum(q))) < 1e-12


def test_ragged_energy_matches_uniform_width_twin():
    """The ragged layout must reproduce the uniform-width padded layout
    (exact by construction) for every energy component and the virial."""
    from metropolismontecarlo_tpu.models.energy import energy_breakdown_jit
    from metropolismontecarlo_tpu.ops.ewald import make_kvectors

    system = _mixture()
    uni = dataclasses.replace(system, species=None)
    box = 20.0
    kv, kw = make_kvectors(PARAMS.nk, PARAMS.ksq_max)

    mc_r = MonteCarlo(system, PARAMS, dtype=jnp.float64, recompute_chunk=2)
    mc_u = MonteCarlo(uni, PARAMS, dtype=jnp.float64, recompute_chunk=2)
    st_r = mc_r.init_state(jax.random.PRNGKey(0),
                           cubic_lattice(system.n_mol, box), box=box,
                           n_chains=2)
    st_u = mc_u.init_state(jax.random.PRNGKey(0),
                           cubic_lattice(uni.n_mol, box), box=box,
                           n_chains=2)
    A_r, A_u = system.n_atoms, uni.n_atoms
    out_r = energy_breakdown_jit(system, PARAMS, st_r.coords[0, :, :A_r].T,
                                 st_r.com[0], st_r.box[0], kv, kw)
    out_u = energy_breakdown_jit(uni, PARAMS, st_u.coords[0, :, :A_u].T,
                                 st_u.com[0], st_u.box[0], kv, kw)
    for k in ("disp", "lrc", "coul_real", "coul_fourier", "coul_self",
              "coul_intra", "total", "w", "w_ref"):
        a, b = float(out_r[k]), float(out_u[k])
        assert abs(a - b) <= 1e-9 * max(abs(a), 1.0), (k, a, b)


def test_ragged_move_path_drift():
    """Per-species sweep bodies on the ragged layout: accumulated deltas
    must match the full recompute (f64, jnp path)."""
    system = _mixture()
    mc = MonteCarlo(system, PARAMS, dtype=jnp.float64, recompute_chunk=2)
    state = mc.init_state(jax.random.PRNGKey(1),
                          cubic_lattice(system.n_mol, 20.0), box=20.0,
                          n_chains=4)
    state = mc.quench(state, 3)
    state, metrics = mc.run_block(state, n_steps=8, adjust=False)
    assert metrics["drift_max_rel"] < 1e-10, metrics["drift_max_rel"]
    assert metrics["acc_trans"] > 0.02
    assert metrics["acc_rot"] > 0.02


def test_ragged_virial_matches_fd():
    """The exact molecular virial holds on ragged mixtures too."""
    from metropolismontecarlo_tpu.models.energy import pressure

    system = _mixture(n_wide=2, n_sol=12)
    mc = MonteCarlo(system, PARAMS, dtype=jnp.float64, recompute_chunk=2)
    state = mc.init_state(jax.random.PRNGKey(2),
                          cubic_lattice(system.n_mol, 14.0), box=14.0,
                          n_chains=2)
    state = mc.quench(state, 3)
    p_fd = float(mc.pressure_fd(state, rel_eps=1e-6)[0])
    p_v = float(pressure(PARAMS, system.n_mol,
                         float(state.box[0]) ** 3, state.virial)[0])
    assert abs(p_v - p_fd) < 1e-5 * max(abs(p_fd), 1.0), (p_v, p_fd)


def test_ragged_npt_volume_drift():
    """NPT volume moves on the RAGGED mixture: the volume move rebuilds
    atoms through the driver's ragged-aware build_coords and must keep
    the drift invariant (accumulated deltas + accepted recomputes ==
    fresh recompute) through accepted volume changes."""
    params = dataclasses.replace(PARAMS, pressure=0.0024, p_volume=0.5,
                                 dv_max=0.05, strict_min_image=False)
    system = _mixture(n_wide=2, n_sol=12)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=2)
    state = mc.init_state(jax.random.PRNGKey(3),
                          cubic_lattice(system.n_mol, 14.0), box=14.0,
                          n_chains=4)
    state = mc.quench(state, 3)
    att0 = int(state.att[0, 2])
    state, metrics = mc.run_block(state, n_steps=8, adjust=False)
    assert metrics["drift_max_rel"] < 1e-10, metrics["drift_max_rel"]
    # period 2: 4 scheduled all-chain attempts in 8 sweeps
    assert int(state.att[0, 2]) - att0 == 4
    assert float(jnp.max(jnp.abs(state.box - 14.0))) > 0.0  # moved volume


def test_tp_full_energy_ragged():
    """Tensor-parallel recompute on a RAGGED mixture: the row-sharded
    tiled path must match the unsharded full_energy (the row padding to
    block*shards multiples and the per-species intra terms must survive
    the atoms-axis split)."""
    from metropolismontecarlo_tpu.parallel.tp import (
        make_mesh_2d, tp_full_energy_fn)

    system = _mixture()
    box = 16.0
    mc = MonteCarlo(system, PARAMS, dtype=jnp.float64, recompute_chunk=2)
    state = mc.init_state(jax.random.PRNGKey(2),
                          cubic_lattice(system.n_mol, box), box=box,
                          n_chains=4)
    state = mc.run_steps(state, 2, False)
    e_ref, w_ref, sfac_ref = mc.full_energy(state)

    fn = tp_full_energy_fn(system, PARAMS, make_mesh_2d(2, 4),
                           mc.kvecs, mc.kweights, recompute_chunk=2,
                           row_block=8)
    e, w, sfac = fn(state.coords, state.com, state.box)
    np.testing.assert_allclose(np.asarray(e), np.asarray(e_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(sfac), np.asarray(sfac_ref),
                               rtol=1e-10, atol=1e-12)
