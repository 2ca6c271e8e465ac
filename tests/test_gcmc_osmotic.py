"""Osmotic-ensemble MC (solute exchange in fixed solvent): exact model
consistency, ideal-solute Poisson statistics, Henry-law consistency vs
species-resolved Widom, and the Ewald drift invariant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.mc.gcmc_osmotic import OsmoticGCMC
from metropolismontecarlo_tpu.models.system import RunParams, System
from metropolismontecarlo_tpu.models.water import spce_system


def lj_plus_trimer(ns, cap, eps_solvent=1.0, eps_solute=1.0,
                   eps_cross=None, sigma=1.0):
    """Two-species test System: monatomic LJ solvent (type 0) + bent-
    triatomic solute (type 1), Lorentz-Berthelot cross terms."""
    from metropolismontecarlo_tpu.models.polyatomic import (
        bent_triatomic_body,
    )
    M, P = ns + cap, 3
    body = np.zeros((M, P, 3))
    body[ns:] = bent_triatomic_body()
    masses = np.zeros((M, P))
    masses[:ns, 0] = 1.0
    masses[ns:] = 1.0
    charges = np.zeros((M, P))
    type_ids = np.zeros((M, P), np.int32)
    type_ids[ns:] = 1
    ec = np.sqrt(eps_solvent * eps_solute) if eps_cross is None \
        else eps_cross
    eps_t = np.array([[eps_solvent, ec], [ec, eps_solute]])
    sig_t = np.full((2, 2), sigma)
    return System(n_mol=M, atoms_per_mol=P, body=body, masses=masses,
                  charges=charges, type_ids=type_ids, eps_table=eps_t,
                  sig_table=sig_t, name="lj+trimer",
                  species=(("solv", ns, 1), ("solu", cap, 3)))


def water_plus_water(ns, cap):
    """SPC/E solvent + SPC/E 'solute' as two blocks — physically one
    fluid, but exercising the full two-species osmotic machinery with
    charges."""
    w = spce_system(ns + cap)
    return System(n_mol=ns + cap, atoms_per_mol=3, body=w.body,
                  masses=w.masses, charges=w.charges,
                  type_ids=w.type_ids, eps_table=w.eps_table,
                  sig_table=w.sig_table, name="spce2",
                  species=(("wA", ns, 3), ("wB", cap, 3)))


def test_osmotic_full_energy_matches_model():
    """All solute slots active: the app's recompute equals the
    production energy model of the two-block system exactly (Ewald)."""
    from metropolismontecarlo_tpu.models.energy import energy_breakdown
    from metropolismontecarlo_tpu.ops.ewald import make_kvectors

    sys2 = water_plus_water(6, 4)
    params = RunParams(temperature=400.0, r_cut=5.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=0.5, dphi_max=0.5)
    g = OsmoticGCMC(sys2, params, activity=1e-4, p_exchange=0.0)
    st = g.init(jax.random.PRNGKey(0), box=12.0, n_init=4, n_chains=2)
    kv, kw = make_kvectors(params.nk, params.ksq_max)
    A = sys2.n_atoms
    for c in range(2):
        out = energy_breakdown(sys2, params, st.coords[c, :, :A].T,
                               st.com[c], st.box[c], kv, kw)
        assert float(st.energy[c]) == pytest.approx(float(out["total"]),
                                                    rel=1e-9)
    # and again after a block of solvent+solute moves
    st, stats = g.run_block(st, 300, drift_tol=1e-9)
    assert stats["acc_trans"] > 0.0 and stats["acc_rot"] > 0.0
    for c in range(2):
        out = energy_breakdown(sys2, params, st.coords[c, :, :A].T,
                               st.com[c], st.box[c], kv, kw)
        assert float(st.energy[c]) == pytest.approx(float(out["total"]),
                                                    rel=1e-9)


def test_osmotic_ideal_solute_poisson():
    """A non-interacting solute in an INTERACTING solvent must still be
    Poisson(z V) — the solvent cannot influence an ideal species."""
    z, box, ns = 0.02, 10.0, 40
    sysO = lj_plus_trimer(ns, 64, eps_solute=0.0, eps_cross=0.0)
    params = RunParams(strict_min_image=False, temperature=1.5, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=0.4, dphi_max=1.0, use_lrc=False)
    g = OsmoticGCMC(sysO, params, activity=z, p_exchange=0.6)
    st = g.init(jax.random.PRNGKey(1), box=box, n_init=20, n_chains=192)
    st, _ = g.run_block(st, 2500)
    means, varis = [], []
    for _ in range(6):
        st, stats = g.run_block(st, 700, drift_tol=1e-10)
        means.append(stats["n_mean"])
        varis.append(stats["n_var"])
        assert stats["full_frac"] == 0.0
    zv = z * box**3
    assert np.mean(means) == pytest.approx(zv, rel=0.03), means
    assert np.mean(varis) == pytest.approx(zv, rel=0.12), varis


def test_osmotic_henry_widom_consistency():
    """Interacting solute in an LJ solvent: beta mu_ex(solute) =
    ln(z / <rho_u>) from the osmotic run must match species-resolved
    Widom insertions on a fixed-composition NVT run of the MAIN driver
    (independent sampler, independent state layout)."""
    z, box, t, ns = 0.08, 6.0, 3.0, 40
    params = RunParams(strict_min_image=False, temperature=t, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=0.4, dphi_max=1.0, use_lrc=False)
    g = OsmoticGCMC(lj_plus_trimer(ns, 48), params, activity=z,
                    p_exchange=0.4, n_orient=4)
    st = g.init(jax.random.PRNGKey(2), box=box, n_init=8, n_chains=96)
    st, _ = g.run_block(st, 3500)
    n_means = []
    for _ in range(4):
        st, stats = g.run_block(st, 900, drift_tol=1e-10)
        n_means.append(stats["n_mean"])
        assert stats["full_frac"] == 0.0
    n_mean = float(np.mean(n_means))
    bmu_gcmc = np.log(z / (n_mean / box**3))

    from metropolismontecarlo_tpu.io.configs import cubic_lattice
    from metropolismontecarlo_tpu.mc.driver import MonteCarlo

    n_u = int(round(n_mean))
    sys_fix = lj_plus_trimer(ns, n_u)
    mc = MonteCarlo(sys_fix, params, dtype=jnp.float64,
                    recompute_chunk=16)
    state = mc.init_state(jax.random.PRNGKey(3),
                          cubic_lattice(ns + n_u, box), box=box,
                          n_chains=64)
    state = mc.run_steps(state, 250, False)
    bsum = 0.0
    for i in range(5):
        state = mc.run_steps(state, 50, False)
        w = mc.widom(state, jax.random.PRNGKey(400 + i),
                     n_insertions=256, species=1)
        bsum += float(jnp.mean(w["boltzmann_mean"])) / 5
    bmu_widom = -np.log(bsum)
    assert bmu_gcmc == pytest.approx(bmu_widom, abs=0.15), \
        (bmu_gcmc, bmu_widom, n_mean)


def test_osmotic_water_ewald_drift():
    """Charged solvent + charged solute (both SPC/E): carried energy and
    structure factors exact through solvent moves AND solute exchanges
    (with orientational bias)."""
    params = RunParams(temperature=1000.0, r_cut=8.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=1.0, dphi_max=0.7)
    g = OsmoticGCMC(water_plus_water(12, 15), params, activity=2e-3,
                    p_exchange=0.5, n_orient=4)
    st = g.init(jax.random.PRNGKey(4), box=20.0, n_init=6, n_chains=12)
    ins = dels = 0.0
    for _ in range(2):
        st, stats = g.run_block(st, 500, drift_tol=1e-9)
        assert stats["sfac_err_max"] < 1e-8, stats
        ins += stats["acc_insert"]
        dels += stats["acc_delete"]
    assert ins > 0.0 and dels > 0.0, (ins, dels)


def test_osmotic_validation_guards():
    params = RunParams(temperature=300.0, r_cut=5.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False)
    with pytest.raises(ValueError, match="two species"):
        OsmoticGCMC(spce_system(8), params, activity=1e-4)
    # use_lrc=True is SUPPORTED since round 5; building must succeed
    OsmoticGCMC(water_plus_water(4, 4),
                RunParams(temperature=300.0, r_cut=5.0,
                          cutoff_mode="site", coulomb="ewald",
                          use_lrc=True), activity=1e-4)


def test_masked_rdf_matches_unmasked_when_all_active():
    """MaskedRDFAccumulator with a full mask must equal RDFAccumulator
    exactly (same histogram, same normalization) on an all-active
    molecular GCMC state."""
    from metropolismontecarlo_tpu.mc.gcmc_mol import MolGCMC
    from metropolismontecarlo_tpu.observables import (
        MaskedRDFAccumulator,
        RDFAccumulator,
    )

    sysW = spce_system(12)
    params = RunParams(strict_min_image=False, temperature=400.0,
                       r_cut=5.0, cutoff_mode="site", coulomb="ewald",
                       use_lrc=False, p_translate=0.5, dr_max=0.5,
                       dphi_max=0.5)
    g = MolGCMC(sysW, params, activity=1e-4, p_exchange=0.0)
    st = g.init(jax.random.PRNGKey(7), box=12.0, n_init=12, n_chains=4)
    st, _ = g.run_block(st, 200)
    rdf = RDFAccumulator(sysW, 0, 0, r_max=5.0, n_bins=50)
    rdf.update(st)
    mrdf = MaskedRDFAccumulator(sysW, 0, 0, r_max=5.0, n_bins=50)
    mrdf.update(st.coords, st.box, g.atom_mask(st))
    r1, g1 = rdf.result()
    r2, g2 = mrdf.result()
    np.testing.assert_allclose(g2, g1, rtol=1e-12)


def test_masked_rdf_osmotic_solute_solvent():
    """Solute-solvent g(r) from an osmotic run: finite, non-negative,
    and decorrelated (~1) at the largest sampled r."""
    from metropolismontecarlo_tpu.observables import MaskedRDFAccumulator

    sysO = lj_plus_trimer(40, 48)
    params = RunParams(strict_min_image=False, temperature=3.0, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=0.4, dphi_max=1.0, use_lrc=False)
    g = OsmoticGCMC(sysO, params, activity=0.08, p_exchange=0.4)
    st = g.init(jax.random.PRNGKey(8), box=6.0, n_init=8, n_chains=32)
    st, _ = g.run_block(st, 2500)
    rdf = MaskedRDFAccumulator(sysO, 0, 1, r_max=2.8, n_bins=40)
    for _ in range(4):
        st, stats = g.run_block(st, 400, drift_tol=1e-10)
        rdf.update(st.coords, st.box, g.atom_mask(st))
    r, gr = rdf.result()
    assert np.isfinite(gr).all() and (gr >= 0.0).all()
    tail = gr[r > 2.4].mean()
    assert 0.5 < tail < 2.0, (tail, gr)
