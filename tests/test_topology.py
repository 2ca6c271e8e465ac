"""Topology front-end tests: golden parses of the reference's GROMACS
files (water.top, topol.top, tip3p.pdb, mea.pdb; skipped while those are
absent), the same front end on a topology generated from the
repository's own SPC/E and CO2 parameters, mixed-species system
assembly, and MC drift on the mixtures."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.io.pdb import read_pdb
from metropolismontecarlo_tpu.io.topology import read_top
from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.from_topology import (
    system_from_topology,
    templates_from_pdbs,
)
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.utils.constants import KJ_PER_MOL_TO_K


def test_parse_water_top(reference_dir):
    top = read_top(os.path.join(reference_dir, "water.top"))
    assert top.defaults["comb_rule"] == 2
    assert top.defaults["fudge_qq"] == pytest.approx(0.8333)
    assert "O1" in top.atom_types and "H" in top.atom_types
    assert top.atom_types["O1"].sigma_nm == pytest.approx(0.315061)
    assert top.atom_types["O1"].epsilon_kj == pytest.approx(0.6364)
    wat = top.mol_types["WAT"]
    assert [a[0] for a in wat.atoms] == ["O1", "H", "H"]
    assert [a[1] for a in wat.atoms] == pytest.approx([-0.834, 0.417, 0.417])
    # the #ifndef FLEXIBLE branch must pick settles+exclusions, not bonds
    assert wat.settles and wat.exclusions and not wat.bonds
    assert top.molecules == [("WAT", 1000)]


def test_parse_topol_top_mea(reference_dir):
    top = read_top(os.path.join(reference_dir, "topol.top"))
    mea = top.mol_types["MEA_DUMMY"]
    assert len(mea.atoms) == 11
    # net charge ~ 0 for the active (uncommented) charge set
    assert sum(a[1] for a in mea.atoms) == pytest.approx(0.0, abs=1e-4)
    assert len(mea.bonds) > 0 and len(mea.angles) > 0 and len(mea.dihedrals) > 0
    sol = top.mol_types["SOL"]
    assert len(sol.atoms) == 3 and sol.settles
    assert ("MEA_DUMMY", 1) in top.molecules and ("SOL", 1000) in top.molecules


def test_parse_pdb_templates(reference_dir):
    tip3p = read_pdb(os.path.join(reference_dir, "tip3p.pdb"))
    assert tip3p["coords"].shape == (3, 3)
    # O-H bond lengths ~0.96-1.0 A in the template
    d = np.linalg.norm(tip3p["coords"][1:] - tip3p["coords"][0], axis=1)
    assert np.all((d > 0.9) & (d < 1.1))
    mea = read_pdb(os.path.join(reference_dir, "mea.pdb"))
    assert mea["coords"].shape == (11, 3)
    assert mea["box"] is not None and mea["box"][0] == pytest.approx(28.65)


def _mixed_system(reference_dir, n_mea=2, n_sol=12):
    top = read_top(os.path.join(reference_dir, "topol.top"))
    templates = templates_from_pdbs(top, {
        "MEA_DUMMY": os.path.join(reference_dir, "mea.pdb"),
        "SOL": os.path.join(reference_dir, "tip3p.pdb"),
    })
    return system_from_topology(
        top, templates, molecules=[("MEA_DUMMY", n_mea), ("SOL", n_sol)],
        name="mea_tip3p",
    )


def test_mixed_system_assembly(reference_dir):
    system = _mixed_system(reference_dir)
    assert system.n_mol == 14 and system.atoms_per_mol == 11
    # padding: SOL molecules have 8 zero-mass slots
    assert np.sum(system.masses[2] > 0) == 3
    assert np.sum(system.masses[0] > 0) == 11
    # charges: neutral overall, SOL rows match tip3p
    assert system.charges.sum() == pytest.approx(0.0, abs=1e-3)
    assert system.charges[2][:3] == pytest.approx([-0.834, 0.417, 0.417])
    # epsilon conversion kJ/mol -> K (O1: 0.6364 kJ/mol)
    o1 = system.type_ids[2][0]
    assert system.eps_table[o1, o1] == pytest.approx(0.6364 * KJ_PER_MOL_TO_K)
    # padded slots interact with nothing
    pad = system.type_ids[2][-1]
    assert np.all(system.eps_table[pad] == 0.0)


def test_mixed_species_mc_drift(reference_dir):
    """BASELINE config #5 in miniature: MEA + TIP3P, Ewald NVT — padded
    slots must contribute exactly zero and deltas must match recompute."""
    system = _mixed_system(reference_dir)
    params = RunParams(temperature=300.0, r_cut=6.0, cutoff_mode="site",
                       coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
                       dr_max=0.3, dphi_max=0.3)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=4)
    state = mc.init_state(jax.random.PRNGKey(0),
                          cubic_lattice(system.n_mol, 14.0), box=14.0,
                          n_chains=4)
    state = mc.quench(state, n_steps=5)
    state, metrics = mc.run_block(state, n_steps=10, adjust=False)
    assert metrics["drift_max_rel"] < 1e-10
    assert np.isfinite(metrics["energy_mean"])
    assert metrics["acc_trans"] > 0.01


def test_neighbor_list_path_drift(reference_dir):
    """Verlet neighbor-list move path: accumulated deltas must still match
    the exact full recompute (which is list-free), proving no in-range
    pair is ever missed by the lists."""
    system = _mixed_system(reference_dir, n_mea=2, n_sol=12)
    params = RunParams(temperature=300.0, r_cut=6.0, cutoff_mode="site",
                       coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
                       dr_max=0.3, dphi_max=0.3,
                       nlist_width=13, nlist_skin=2.0)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=4)
    state = mc.init_state(jax.random.PRNGKey(0),
                          cubic_lattice(system.n_mol, 14.0), box=14.0,
                          n_chains=4)
    state = mc.quench(state, 5)
    state, metrics = mc.run_block(state, n_steps=10, adjust=False)
    assert metrics["drift_max_rel"] < 1e-10, metrics["drift_max_rel"]
    assert metrics["acc_trans"] > 0.01


def test_neighbor_list_overflow_detected(reference_dir):
    """Too-small nlist_width must be caught by the block-boundary check,
    not silently drop interactions."""
    system = _mixed_system(reference_dir, n_mea=2, n_sol=12)
    params = RunParams(temperature=300.0, r_cut=6.0, cutoff_mode="site",
                       coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
                       dr_max=0.3, dphi_max=0.3,
                       nlist_width=4, nlist_skin=2.0)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=4)
    state = mc.init_state(jax.random.PRNGKey(0),
                          cubic_lattice(system.n_mol, 14.0), box=14.0,
                          n_chains=4)
    with pytest.raises(RuntimeError, match="neighbor-list overflow"):
        mc.run_block(state, n_steps=2, adjust=False)


# ---- generated inputs: a GROMACS topology + PDB templates written from
# the repository's own SPC/E (models/water.py) and TraPPE CO2
# (models/linear.py) parameters, so the front end is exercised without
# external files -------------------------------------------------------

def _write_spce_co2(tmp_path, n_sol=24, n_co2=8):
    from metropolismontecarlo_tpu.io.pdb import write_pdb
    from metropolismontecarlo_tpu.models import linear as lin
    from metropolismontecarlo_tpu.models import water as wat

    def at(name, mass, sig_a, eps_k):
        return (f"{name:<6s} {mass:.6f} 0.0 A {sig_a / 10.0:.12f} "
                f"{eps_k / KJ_PER_MOL_TO_K:.12f}")

    top = "\n".join([
        "; generated from models/water.py and models/linear.py",
        "[ defaults ]", "1 2 yes 0.5 0.8333", "",
        "[ atomtypes ]",
        at("OW", wat.MASS_O, wat.SPCE_SIGMA_OO, wat.SPCE_EPS_OO),
        at("HW", wat.MASS_H, 0.0, 0.0),
        at("C_co2", lin.MASS_C, lin.CO2_SIG_C, lin.CO2_EPS_C),
        at("O_co2", lin.MASS_O, lin.CO2_SIG_O, lin.CO2_EPS_O), "",
        "[ moleculetype ]", "SOL 2", "[ atoms ]",
        f"1 OW 1 SOL OW  1 {wat.SPCE_Q_O} {wat.MASS_O}",
        f"2 HW 1 SOL HW1 1 {wat.SPCE_Q_H} {wat.MASS_H}",
        f"3 HW 1 SOL HW2 1 {wat.SPCE_Q_H} {wat.MASS_H}",
        "#ifndef FLEXIBLE", "[ settles ]", "1 1 0.1 0.16330",
        "[ exclusions ]", "1 2 3", "2 1 3", "3 1 2", "#else",
        "[ bonds ]", "1 2 1 0.1 345000", "1 3 1 0.1 345000", "#endif", "",
        "[ moleculetype ]", "CO2 1", "[ atoms ]",
        f"1 C_co2 1 CO2 C  1 {lin.CO2_Q_C} {lin.MASS_C}",
        f"2 O_co2 1 CO2 O1 1 {lin.CO2_Q_O} {lin.MASS_O}",
        f"3 O_co2 1 CO2 O2 1 {lin.CO2_Q_O} {lin.MASS_O}", "",
        "[ system ]", "SPC/E water with TraPPE CO2", "",
        "[ molecules ]", f"SOL {n_sol}", f"CO2 {n_co2}", ""])
    (tmp_path / "spce_co2.top").write_text(top)
    write_pdb(tmp_path / "spce.pdb",
              wat.water_body_frame(wat.SPCE_R_OH, wat.SPCE_THETA),
              ["OW", "HW1", "HW2"], ["SOL"] * 3, [1] * 3, box=30.0)
    write_pdb(tmp_path / "co2.pdb", lin.co2_body_frame(),
              ["C", "O1", "O2"], ["CO2"] * 3, [1] * 3)
    return (str(tmp_path / "spce_co2.top"),
            {"SOL": str(tmp_path / "spce.pdb"),
             "CO2": str(tmp_path / "co2.pdb")})


def _generated_system(tmp_path, molecules=None):
    top_path, pdbs = _write_spce_co2(tmp_path)
    top = read_top(top_path)
    return system_from_topology(top, templates_from_pdbs(top, pdbs),
                                molecules=molecules, name="spce_co2")


def test_parse_generated_top(tmp_path):
    from metropolismontecarlo_tpu.models.water import (
        SPCE_EPS_OO, SPCE_Q_H, SPCE_Q_O, SPCE_SIGMA_OO)

    top_path, _ = _write_spce_co2(tmp_path)
    top = read_top(top_path)
    assert top.defaults["comb_rule"] == 2
    assert top.defaults["fudge_qq"] == pytest.approx(0.8333)
    ow = top.atom_types["OW"]
    assert ow.sigma_nm * 10.0 == pytest.approx(SPCE_SIGMA_OO, rel=1e-12)
    assert ow.epsilon_kj * KJ_PER_MOL_TO_K == pytest.approx(SPCE_EPS_OO,
                                                           rel=1e-12)
    sol = top.mol_types["SOL"]
    assert [a[1] for a in sol.atoms] == pytest.approx(
        [SPCE_Q_O, SPCE_Q_H, SPCE_Q_H])
    # the #ifndef FLEXIBLE branch picks settles+exclusions, not bonds
    assert sol.settles and sol.exclusions and not sol.bonds
    flex = read_top(top_path, defines=("FLEXIBLE",))
    assert flex.mol_types["SOL"].bonds and not flex.mol_types["SOL"].settles
    assert top.molecules == [("SOL", 24), ("CO2", 8)]
    assert len(top.mol_types["CO2"].atoms) == 3


def test_parse_generated_pdb_templates(tmp_path):
    _, pdbs = _write_spce_co2(tmp_path)
    w = read_pdb(pdbs["SOL"])
    assert w["coords"].shape == (3, 3) and w["box"][0] == pytest.approx(30.0)
    d = np.linalg.norm(w["coords"][1:] - w["coords"][0], axis=1)
    np.testing.assert_allclose(d, 1.0, atol=2e-3)      # %8.3f columns
    c = read_pdb(pdbs["CO2"])
    assert c["atom_names"] == ["C", "O1", "O2"]


def test_generated_topology_matches_builtin_models(tmp_path):
    """from_topology on the generated files reproduces the built-in
    SPC/E + CO2 mixture's energy (same parameters, LB mixing)."""
    from metropolismontecarlo_tpu.models.energy import energy_breakdown_jit
    from metropolismontecarlo_tpu.models.linear import co2_system
    from metropolismontecarlo_tpu.models.mixture import mixture_system
    from metropolismontecarlo_tpu.models.water import spce_system

    topo = _generated_system(tmp_path)
    assert [s[:2] for s in topo.species] == [("SOL", 24), ("CO2", 8)]
    import dataclasses

    built = mixture_system([(spce_system(1), 24), (co2_system(1), 8)])
    np.testing.assert_allclose(topo.charges, built.charges)
    # PDB templates carry 3 decimals: bodies agree to 1e-3 A; compare the
    # force fields on identical bodies
    np.testing.assert_allclose(topo.body, built.body, atol=2e-3)
    built = dataclasses.replace(built, body=topo.body)
    params = RunParams(temperature=300.0, r_cut=6.0, cutoff_mode="site",
                       coulomb="ewald", nk=3, ksq_max=9)
    box = 14.0
    energies = []
    for system in (topo, built):
        mc = MonteCarlo(system, params, dtype=jnp.float64,
                        recompute_chunk=1)
        st = mc.init_state(jax.random.PRNGKey(4),
                           cubic_lattice(system.n_mol, box), box=box,
                           n_chains=1)
        A = system.n_atoms
        energies.append(energy_breakdown_jit(
            system, params, st.coords[0, :, :A].T, st.com[0], st.box[0],
            mc.kvecs, mc.kweights))
    for k in ("disp", "coul_real", "coul_fourier", "coul_self",
              "coul_intra", "total"):
        a, b = float(energies[0][k]), float(energies[1][k])
        assert abs(a - b) <= 1e-10 * max(abs(b), 1.0), (k, a, b)


def test_generated_mixed_species_mc_drift(tmp_path):
    """SPC/E + CO2 from the generated topology, Ewald NVT: carried
    deltas must match the recompute (f64)."""
    system = _generated_system(tmp_path, [("SOL", 12), ("CO2", 4)])
    params = RunParams(temperature=300.0, r_cut=6.0, cutoff_mode="site",
                       coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
                       dr_max=0.3, dphi_max=0.3)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=4)
    state = mc.init_state(jax.random.PRNGKey(0),
                          cubic_lattice(system.n_mol, 14.0), box=14.0,
                          n_chains=4)
    state = mc.quench(state, n_steps=3)
    state, metrics = mc.run_block(state, n_steps=6, adjust=False)
    assert metrics["drift_max_rel"] < 1e-10
    assert metrics["acc_trans"] > 0.01


def test_generated_neighbor_list_path_drift(tmp_path):
    """Verlet neighbor-list move path on the generated mixture: deltas
    must match the list-free recompute, and a too-small list width must
    be caught at the block boundary."""
    system = _generated_system(tmp_path, [("SOL", 12), ("CO2", 4)])
    base = dict(temperature=300.0, r_cut=6.0, cutoff_mode="site",
                coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
                dr_max=0.3, dphi_max=0.3, nlist_skin=2.0)
    mc = MonteCarlo(system, RunParams(nlist_width=15, **base),
                    dtype=jnp.float64, recompute_chunk=4)
    state = mc.init_state(jax.random.PRNGKey(0),
                          cubic_lattice(system.n_mol, 14.0), box=14.0,
                          n_chains=4)
    state, metrics = mc.run_block(mc.quench(state, 3), n_steps=6,
                                  adjust=False)
    assert metrics["drift_max_rel"] < 1e-10, metrics["drift_max_rel"]
    small = MonteCarlo(system, RunParams(nlist_width=4, **base),
                       dtype=jnp.float64, recompute_chunk=4)
    state = small.init_state(jax.random.PRNGKey(0),
                             cubic_lattice(system.n_mol, 14.0), box=14.0,
                             n_chains=4)
    with pytest.raises(RuntimeError, match="neighbor-list overflow"):
        small.run_block(state, n_steps=2, adjust=False)
