"""The float64 NumPy reference (metropolismontecarlo_tpu/reference.py)
against the JAX energy model and against the energies the jnp move path
carries, for every model family the shipped configurations use, on
seeded configurations built in the repository."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.energy import energy_breakdown_jit
from metropolismontecarlo_tpu.models.linear import co2_system
from metropolismontecarlo_tpu.models.mixture import mixture_system
from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.polyatomic import (
    mossa_params,
    triatomic_system,
)
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system, tip4p2005_system
from metropolismontecarlo_tpu.ops.ewald import make_kvectors
from metropolismontecarlo_tpu.reference import energy_components

F64 = jnp.float64
_WATER = dict(r_cut=6.0, dr_max=0.3, dphi_max=0.3)
_EWALD = dict(coulomb="ewald", nk=4, ksq_max=17, **_WATER)

# name -> (system, params, box); every model family of the shipped
# configurations, at <= 64 molecules
MODELS = {
    "lj": (lj_system(64), RunParams(temperature=1.0, r_cut=2.5,
                                    p_translate=1.0, dr_max=0.3), 5.2),
    "lj_linear_shift": (lj_system(64), RunParams(
        temperature=1.0, r_cut=2.5, lj_shift="linear", p_translate=1.0,
        dr_max=0.3), 5.2),
    "mossa_triatomic": (triatomic_system(27), mossa_params(), 5.4),
    "spce_ewald": (spce_system(32), RunParams(**_EWALD), 12.5),
    "spce_ewald_surface": (spce_system(32), RunParams(
        ewald_surface=True, **_EWALD), 12.5),
    "spce_wolf_pairwise": (spce_system(32), RunParams(
        coulomb="wolf", **_WATER), 12.5),
    "spce_wolf_reference": (spce_system(32), RunParams(
        coulomb="wolf", wolf_style="reference", **_WATER), 12.5),
    "spce_bare": (spce_system(32), RunParams(coulomb="bare", **_WATER),
                  12.5),
    "tip4p2005": (tip4p2005_system(32), RunParams(**_EWALD), 12.5),
    "co2": (co2_system(27), RunParams(temperature=250.0, **_EWALD), 13.0),
    "spce_co2": (mixture_system([(spce_system(1), 24), (co2_system(1), 8)]),
                 RunParams(**_EWALD), 14.0),
    "ragged_spce_tip4p": (mixture_system([(tip4p2005_system(1), 8),
                                          (spce_system(1), 24)]),
                          RunParams(**_EWALD), 12.5),
}


def _state(name, dtype=F64, n_chains=2, sweeps=0):
    system, params, box = MODELS[name]
    mc = MonteCarlo(system, params, dtype=dtype, recompute_chunk=2)
    state = mc.init_state(jax.random.PRNGKey(7), cubic_lattice(
        system.n_mol, box), box=box, n_chains=n_chains)
    if sweeps:
        state = mc.run_steps(state, sweeps, False)
    return mc, state


def _reference(mc, state, c):
    A = mc.system.n_atoms
    return energy_components(mc.system, mc.params,
                             np.asarray(state.coords[c, :, :A].T),
                             np.asarray(state.com[c]),
                             float(state.box[c]))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_reference_matches_energy_model(name):
    """Every component of models.energy (f64) equals the independent
    NumPy sum to roundoff."""
    mc, state = _state(name)
    A = mc.system.n_atoms
    for c in range(2):
        out = energy_breakdown_jit(mc.system, mc.params,
                                   state.coords[c, :, :A].T, state.com[c],
                                   state.box[c], mc.kvecs, mc.kweights)
        ref = _reference(mc, state, c)
        scale = max(1.0, sum(abs(v) for k, v in ref.items()
                             if k != "total"))
        for k, v in ref.items():
            assert abs(float(out[k]) - v) <= 1e-11 * scale, (k, out[k], v)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_carried_energy_matches_reference(name):
    """The jnp move path's CARRIED energy (accumulated per-move deltas,
    no resync) after a few sweeps equals the reference energy of the
    configuration it reached."""
    mc, state = _state(name, sweeps=3)
    assert int(jnp.sum(state.acc)) > 0           # moves were accepted
    for c in range(2):
        ref = _reference(mc, state, c)
        scale = max(1.0, sum(abs(v) for k, v in ref.items()
                             if k != "total"))
        assert abs(float(state.energy[c]) - ref["total"]) <= 1e-10 * scale


def test_reference_kset_is_the_folded_half_space():
    """The reference sums the full k-set; the model folds it into a half
    space with weight 2 — the same set of |k| terms."""
    from metropolismontecarlo_tpu.reference import _kvectors

    full = _kvectors(5, 27)
    kv, kw = make_kvectors(5, 27)
    assert full.shape[0] == int(round(kw.sum()))
    k2_full = np.sort(np.sum(full * full, 1))
    k2_half = np.sort(np.repeat(np.sum(kv * kv, 1), kw.astype(int)))
    np.testing.assert_array_equal(k2_full, k2_half)


def test_reference_covers_site_cutoff_only():
    system, params, box = MODELS["spce_ewald"]
    with pytest.raises(NotImplementedError):
        energy_components(system, dataclasses.replace(
            params, cutoff_mode="com"), np.zeros((system.n_atoms, 3)),
            np.zeros((system.n_mol, 3)), box)


def test_mixture_tables_and_padding():
    """Within a part its own table; across parts Lorentz-Berthelot of the
    diagonals; narrower species padded with the zero-eps pad type."""
    w, t = spce_system(1), tip4p2005_system(1)
    m = mixture_system([(w, 2), (t, 3)])
    assert m.species == (("spce", 2, 3), ("tip4p2005", 3, 4))
    assert m.n_atoms == 2 * 3 + 3 * 4 and not m.uniform_width
    o_w, o_t = m.type_ids[0, 0], m.type_ids[2, 0]
    assert m.eps_table[o_w, o_w] == w.eps_table[0, 0]
    assert m.eps_table[o_w, o_t] == pytest.approx(
        np.sqrt(w.eps_table[0, 0] * t.eps_table[0, 0]))
    assert m.sig_table[o_w, o_t] == pytest.approx(
        0.5 * (w.sig_table[0, 0] + t.sig_table[0, 0]))
    pad = m.type_ids[0, 3]
    assert np.all(m.eps_table[pad] == 0.0) and m.charges[0, 3] == 0.0
    assert m.masses[0, 3] == 0.0
    np.testing.assert_allclose(m.charges.sum(axis=1), 0.0, atol=1e-12)
