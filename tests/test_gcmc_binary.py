"""Binary-mixture muVT (both species exchangeable): exact model
consistency, independent-Poisson ideal species, the interacting COLOR
symmetry (two identical species at (z, z) == one species at 2z), and
the Ewald drift invariant through mixed exchanges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.mc.gcmc_binary import BinaryGCMC
from metropolismontecarlo_tpu.models.system import RunParams, System
from metropolismontecarlo_tpu.models.water import spce_system


def lj_two_blocks(cap0, cap1, eps=1.0, sigma=1.0):
    """Two MONATOMIC LJ species blocks with identical interactions —
    the color-symmetry fixture."""
    M = cap0 + cap1
    body = np.zeros((M, 1, 3))
    masses = np.ones((M, 1))
    charges = np.zeros((M, 1))
    type_ids = np.zeros((M, 1), np.int32)
    type_ids[cap0:] = 1
    eps_t = np.full((2, 2), eps)
    sig_t = np.full((2, 2), sigma)
    return System(n_mol=M, atoms_per_mol=1, body=body, masses=masses,
                  charges=charges, type_ids=type_ids, eps_table=eps_t,
                  sig_table=sig_t, name="lj2",
                  species=(("A", cap0, 1), ("B", cap1, 1)))


def water_two_blocks(cap0, cap1):
    """SPC/E split into two exchangeable blocks (identical species,
    full charges) — exercises carried structure factors through both
    species' exchanges."""
    w = spce_system(cap0 + cap1)
    return System(n_mol=cap0 + cap1, atoms_per_mol=3, body=w.body,
                  masses=w.masses, charges=w.charges,
                  type_ids=w.type_ids, eps_table=w.eps_table,
                  sig_table=w.sig_table, name="spce2x",
                  species=(("wA", cap0, 3), ("wB", cap1, 3)))


def _lj_params(**kw):
    d = dict(strict_min_image=False, temperature=1.5, r_cut=2.5,
             cutoff_mode="site", coulomb="none", p_translate=1.0,
             dr_max=0.4, use_lrc=False)
    d.update(kw)
    return RunParams(**d)


def test_binary_full_energy_matches_model():
    """All slots of both species active: the app's recompute equals the
    production energy model of the two-block system exactly (Ewald),
    before and after a block of NVT-only moves."""
    from metropolismontecarlo_tpu.models.energy import energy_breakdown
    from metropolismontecarlo_tpu.ops.ewald import make_kvectors

    sys2 = water_two_blocks(5, 4)
    params = RunParams(temperature=400.0, r_cut=5.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=0.5, dphi_max=0.5)
    g = BinaryGCMC(sys2, params, activities=(1e-4, 1e-4),
                   p_exchange=0.0)
    st = g.init(jax.random.PRNGKey(0), box=12.0, n_init=(5, 4),
                n_chains=2)
    kv, kw = make_kvectors(params.nk, params.ksq_max)
    A = sys2.n_atoms

    def model_total(c):
        out = energy_breakdown(sys2, params, st.coords[c, :, :A].T,
                               st.com[c], st.box[c], kv, kw)
        return float(out["total"])

    for c in range(2):
        assert float(st.energy[c]) == pytest.approx(model_total(c),
                                                    rel=1e-9)
    st, stats = g.run_block(st, 300, drift_tol=1e-9)
    assert stats["acc_trans"] > 0.0
    for c in range(2):
        assert float(st.energy[c]) == pytest.approx(model_total(c),
                                                    rel=1e-9)


def test_binary_ideal_species_independent_poisson():
    """eps = 0 for both species at different activities: N_A and N_B
    are independent Poissons."""
    z0, z1, box = 0.03, 0.06, 6.0
    g = BinaryGCMC(lj_two_blocks(40, 60, eps=0.0), _lj_params(),
                   activities=(z0, z1), p_exchange=0.8)
    st = g.init(jax.random.PRNGKey(1), box=box, n_init=(5, 10),
                n_chains=256)
    st, _ = g.run_block(st, 1500)
    m0, m1, v0, v1, cv = [], [], [], [], []
    for _ in range(6):
        st, stats = g.run_block(st, 500, drift_tol=1e-10)
        m0.append(stats["n0_mean"])
        m1.append(stats["n1_mean"])
        v0.append(stats["n0_var"])
        v1.append(stats["n1_var"])
        cv.append(stats["cov01"])
        assert stats["full_frac0"] == 0.0 and stats["full_frac1"] == 0.0
    zv0, zv1 = z0 * box**3, z1 * box**3
    assert np.mean(m0) == pytest.approx(zv0, rel=0.05), m0
    assert np.mean(m1) == pytest.approx(zv1, rel=0.05), m1
    assert np.mean(v0) == pytest.approx(zv0, rel=0.2), v0
    assert np.mean(v1) == pytest.approx(zv1, rel=0.2), v1
    assert abs(np.mean(cv)) < 0.15 * np.sqrt(zv0 * zv1), cv


def test_binary_color_symmetry_vs_single_species():
    """INTERACTING anchor: two identical LJ species at (z, z) have the
    same total-N statistics as single-species muVT at activity 2z —
    Xi_binary(z, z) = sum_N (2z)^N Q_N / N! term-by-term (the species
    labels are colors)."""
    from metropolismontecarlo_tpu.mc.gcmc import GCMC

    z, box = 0.05, 5.0
    params = _lj_params(p_translate=0.4)
    g2 = BinaryGCMC(lj_two_blocks(48, 48), params, activities=(z, z),
                    p_exchange=0.6)
    st2 = g2.init(jax.random.PRNGKey(3), box=box, n_init=(6, 6),
                  n_chains=192)
    # the single-species app takes a uniform one-block system
    from metropolismontecarlo_tpu.models.monatomic import lj_system
    g1 = GCMC(lj_system(1), params, activity=2 * z, capacity=96)
    st1 = g1.init(jax.random.PRNGKey(4), box=box, n_init=12,
                  n_chains=192)
    st2, _ = g2.run_block(st2, 2000)
    st1, _ = g1.run_block(st1, 2000)
    tot2, tot1 = [], []
    for _ in range(6):
        st2, s2 = g2.run_block(st2, 600, drift_tol=1e-10)
        st1, s1 = g1.run_block(st1, 600, drift_tol=1e-10)
        tot2.append(s2["n0_mean"] + s2["n1_mean"])
        tot1.append(s1["n_mean"])
        assert s2["full_frac0"] == 0.0 and s2["full_frac1"] == 0.0
    m2, m1 = np.mean(tot2), np.mean(tot1)
    sem = np.std(tot2) / np.sqrt(6) + np.std(tot1) / np.sqrt(6)
    assert abs(m2 - m1) < max(4 * sem, 0.05 * m1), (m2, m1, sem)


def test_binary_spce_ewald_drift_through_exchanges():
    """Mixed two-species exchanges with full Ewald: carried energy and
    structure factors vs dense recompute (f64)."""
    params = RunParams(strict_min_image=False, temperature=600.0,
                       r_cut=4.5, cutoff_mode="site", coulomb="ewald",
                       use_lrc=False, p_translate=0.5, dr_max=1.0,
                       dphi_max=0.8)
    g = BinaryGCMC(water_two_blocks(7, 7), params,
                   activities=(2e-4, 3e-4), p_exchange=0.5, n_orient=3)
    st = g.init(jax.random.PRNGKey(5), box=10.0, n_init=(3, 2),
                n_chains=6)
    st, stats = g.run_block(st, 600, drift_tol=1e-9)
    assert stats["sfac_err_max"] < 1e-8, stats
    acc_x = (stats["acc_insert0"] + stats["acc_delete0"]
             + stats["acc_insert1"] + stats["acc_delete1"])
    assert acc_x > 0.0, stats


def test_binary_ragged_species_widths():
    """RAGGED two-block system (1-site LJ solvent + 3-site triatomic,
    different atoms-per-molecule): exact full-energy consistency and
    drift through both species' exchanges — the layout the CLI's
    topology-driven binary runs (e.g. water + MEA) rely on."""
    from test_gcmc_osmotic import lj_plus_trimer

    sys2 = lj_plus_trimer(24, 16)
    params = _lj_params(p_translate=0.5, dphi_max=0.8)
    g = BinaryGCMC(sys2, params, activities=(0.05, 0.02),
                   p_exchange=0.5, n_orient=3)
    st = g.init(jax.random.PRNGKey(9), box=6.0, n_init=(10, 5),
                n_chains=8)
    # all-active check against the production model (LJ-only)
    from metropolismontecarlo_tpu.models.energy import energy_breakdown
    st_full = g.init(jax.random.PRNGKey(10), box=6.0, n_init=(24, 16),
                     n_chains=2)
    A = sys2.n_atoms
    for c in range(2):
        out = energy_breakdown(sys2, params, st_full.coords[c, :, :A].T,
                               st_full.com[c], st_full.box[c], None,
                               None)
        assert float(st_full.energy[c]) == pytest.approx(
            float(out["total"]), rel=1e-9)
    st, stats = g.run_block(st, 800, drift_tol=1e-10)
    acc_x = (stats["acc_insert0"] + stats["acc_delete0"]
             + stats["acc_insert1"] + stats["acc_delete1"])
    assert acc_x > 0.0, stats


def test_binary_validation_guards():
    sys2 = lj_two_blocks(8, 8)
    # use_lrc=True is SUPPORTED since round 5; building must succeed
    BinaryGCMC(sys2, _lj_params(use_lrc=True, lj_shift="none"),
               activities=(0.1, 0.1))
    with pytest.raises(ValueError, match="two species"):
        from metropolismontecarlo_tpu.models.monatomic import lj_system
        BinaryGCMC(lj_system(8), _lj_params(), activities=(0.1, 0.1))
    with pytest.raises(ValueError, match="pair"):
        BinaryGCMC(sys2, _lj_params(), activities=(0.1,))


def test_binary_atom_ok_matches_slots_and_batches():
    """The standalone binary_atom_ok equals make_binary_slots'
    atom_ok_of on random masks, and broadcasts over leading batch
    dims (the observable-accumulation use)."""
    from metropolismontecarlo_tpu.mc.gcmc_binary import (
        binary_atom_ok,
        make_binary_slots,
    )

    sys2 = water_two_blocks(5, 3)
    params = _lj_params()
    ms = make_binary_slots(sys2, params, jnp.float64)
    key = jax.random.PRNGKey(0)
    a0 = jax.random.bernoulli(key, 0.6, (4, 2, 5))
    a1 = jax.random.bernoulli(jax.random.PRNGKey(1), 0.6, (4, 2, 3))
    batched = binary_atom_ok(sys2, a0, a1)            # (4, 2, A_pad)
    for c in range(4):
        for b in range(2):
            ref = ms.atom_ok_of(a0[c, b], a1[c, b])
            assert bool(jnp.all(batched[c, b] == ref)), (c, b)
