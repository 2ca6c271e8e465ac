"""Molecular Gibbs ensemble: binomial partitioning, density equality,
chemical-potential equality for an interacting triatomic, and the Ewald
drift invariant through transfers and volume exchanges."""

import jax
import numpy as np
import pytest

from metropolismontecarlo_tpu.mc.gibbs_mol import MolGibbsEnsemble
from metropolismontecarlo_tpu.models.polyatomic import triatomic_system
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system


def test_gibbs_mol_ideal_binomial():
    """Ideal rigid rotor, volume moves off, V1 = V2: each molecule is in
    box 1 with probability 1/2, so N1 ~ Binomial(N, 1/2) — mean and
    variance closed forms; total N strictly conserved."""
    n_tot = 40
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.0,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       p_volume=0.0, dr_max=1.0, dphi_max=1.0,
                       use_lrc=False)
    g = MolGibbsEnsemble(triatomic_system(64, eps=0.0), params,
                         p_transfer=0.6)
    st = g.init(jax.random.PRNGKey(0), boxes=(8.0, 8.0),
                n_init=(20, 20), n_chains=192)
    st, _ = g.run_block(st, 1500)
    n1 = []
    for _ in range(6):
        st, stats = g.run_block(st, 400, drift_tol=1e-10)
        n1.append(np.asarray(st.active[:, 0].sum(axis=1), np.float64))
    n1 = np.concatenate(n1)
    assert n1.mean() == pytest.approx(n_tot / 2, rel=0.03), n1.mean()
    assert n1.var() == pytest.approx(n_tot / 4, rel=0.15), n1.var()
    n_all = np.asarray(st.active.sum(axis=(1, 2)))
    assert (n_all == n_tot).all()


def test_gibbs_mol_triatomic_density_and_mu_equality():
    """Interacting LJ triatomic at supercritical T with volume AND
    transfer moves, started from deliberately unequal densities: the
    boxes must equilibrate to equal densities and equal full chemical
    potentials beta mu = ln rho - ln<exp(-beta dU_test)> (per-box
    molecular Widom insertions with orientations)."""
    params = RunParams(strict_min_image=False, temperature=3.0, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       p_volume=0.05, dr_max=0.5, dphi_max=1.0,
                       use_lrc=False)
    g = MolGibbsEnsemble(triatomic_system(48), params, dv_max=0.05,
                         p_transfer=0.4)
    st = g.init(jax.random.PRNGKey(1), boxes=(6.5, 5.0),
                n_init=(30, 14), n_chains=48)
    st, _ = g.run_block(st, 4000)
    nsum = np.zeros(2)
    vsum = np.zeros(2)
    b = np.zeros(2)
    blocks = 4
    for i in range(blocks):
        st, stats = g.run_block(st, 800, drift_tol=1e-10)
        nsum += np.asarray(st.active.sum(axis=2), np.float64).mean(axis=0)
        vsum += (np.asarray(st.box, np.float64) ** 3).mean(axis=0)
        bw = np.asarray(g.widom_boltzmann(st, jax.random.PRNGKey(70 + i),
                                          512), np.float64)
        b += bw.mean(axis=0) / blocks
    # ratio-of-means <N>/<V>: the mean-of-ratios <N/V> estimator carries
    # a Jensen bias from the small box's large volume fluctuations
    r = nsum / vsum
    assert r[0] == pytest.approx(r[1], rel=0.12), r
    bmu = np.log(r) - np.log(b)
    assert bmu[0] == pytest.approx(bmu[1], abs=0.15), (bmu, r, b)


def test_gibbs_mol_spce_ewald_drift():
    """SPC/E water with full Ewald: carried per-box energies and
    structure factors must survive transfers (with the box-dependent
    self+intra constants) and volume exchanges (full recompute under
    per-box kappa) — checked against dense recomputes."""
    # kappa_L/nk sized for the LARGER box (the Ewald-consistency guard:
    # both boxes must sample the same converged model)
    from metropolismontecarlo_tpu.ops.ewald import tune_parameters
    kl, nk, ksq = tune_parameters(23.0, 8.0, 1e-3)
    params = RunParams(temperature=600.0, r_cut=8.0, cutoff_mode="site",
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       use_lrc=False, p_translate=0.5,
                       p_volume=0.02, dr_max=1.5, dphi_max=0.8)
    g = MolGibbsEnsemble(spce_system(27), params, dv_max=0.02,
                         p_transfer=0.5)
    st = g.init(jax.random.PRNGKey(2), boxes=(20.0, 23.0),
                n_init=(16, 8), n_chains=8)
    xfers = vols = 0.0
    for _ in range(2):
        st, stats = g.run_block(st, 400, drift_tol=1e-9)
        assert stats["sfac_err_max"] < 1e-8, stats
        xfers += stats["acc_transfer"]
        vols += stats["acc_vol"]
    assert xfers > 0.0, stats
    assert vols > 0.0, stats
    n_all = np.asarray(st.active.sum(axis=(1, 2)))
    assert (n_all == 24).all()


def test_gibbs_mol_orientational_bias_same_ensemble():
    """Orientational-bias transfers (n_orient = 4) must reach the same
    density fixed point as the unbiased sampler, and keep the chemical-
    potential equality — exactness of the Rosenbluth transfer rule."""
    params = RunParams(strict_min_image=False, temperature=3.0, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       p_volume=0.05, dr_max=0.5, dphi_max=1.0,
                       use_lrc=False)
    g = MolGibbsEnsemble(triatomic_system(48), params, dv_max=0.05,
                         p_transfer=0.4, n_orient=4)
    st = g.init(jax.random.PRNGKey(5), boxes=(6.5, 5.0),
                n_init=(30, 14), n_chains=48)
    st, _ = g.run_block(st, 4000)
    nsum = np.zeros(2)
    vsum = np.zeros(2)
    b = np.zeros(2)
    blocks = 3
    for i in range(blocks):
        st, stats = g.run_block(st, 800, drift_tol=1e-10)
        nsum += np.asarray(st.active.sum(axis=2), np.float64).mean(axis=0)
        vsum += (np.asarray(st.box, np.float64) ** 3).mean(axis=0)
        bw = np.asarray(g.widom_boltzmann(st, jax.random.PRNGKey(90 + i),
                                          512), np.float64)
        b += bw.mean(axis=0) / blocks
    r = nsum / vsum           # ratio-of-means (see the unbiased test)
    assert r[0] == pytest.approx(r[1], rel=0.12), r
    bmu = np.log(r) - np.log(b)
    assert bmu[0] == pytest.approx(bmu[1], abs=0.15), (bmu, r, b)
    assert stats["acc_transfer"] > 0.0, stats


def test_gibbs_mol_orientational_bias_ewald_drift():
    """Biased transfers keep the carried per-box energies and structure
    factors exact."""
    from metropolismontecarlo_tpu.ops.ewald import tune_parameters
    kl, nk, ksq = tune_parameters(23.0, 8.0, 1e-3)
    params = RunParams(temperature=600.0, r_cut=8.0, cutoff_mode="site",
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       use_lrc=False, p_translate=0.5,
                       p_volume=0.02, dr_max=1.5, dphi_max=0.8)
    g = MolGibbsEnsemble(spce_system(27), params, dv_max=0.02,
                         p_transfer=0.5, n_orient=4)
    st = g.init(jax.random.PRNGKey(6), boxes=(20.0, 23.0),
                n_init=(16, 8), n_chains=8)
    xfers = 0.0
    for _ in range(2):
        st, stats = g.run_block(st, 400, drift_tol=1e-9)
        assert stats["sfac_err_max"] < 1e-8, stats
        xfers += stats["acc_transfer"]
    assert xfers > 0.0, stats


def test_gibbs_mol_min_image_guard():
    """An initial box below 2*cutoff must be rejected at init (the
    volume move only walls PROPOSED boxes)."""
    params = RunParams(temperature=600.0, r_cut=8.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False)
    g = MolGibbsEnsemble(spce_system(8), params)
    with pytest.raises(ValueError, match="minimum-image"):
        g.init(jax.random.PRNGKey(0), boxes=(15.0, 23.0),
               n_init=(4, 4), n_chains=2)


def test_gibbs_mol_ewald_consistency_guard():
    """Transfers between DIFFERENT-SIZED boxes require the Ewald sums to
    be converged in BOTH (kappa = kappa_L/box makes the truncated model
    box-dependent; measured: supercritical water in (14, 22) boxes with
    the reference kappa_L = 5.6 splits to a 15x density ratio instead
    of equalizing — molecules drain into the box whose mangled
    electrostatics are softer).  The app must refuse such parameters
    and accept tuned ones."""
    from metropolismontecarlo_tpu.ops.ewald import tune_parameters

    params = RunParams(strict_min_image=False, temperature=600.0,
                       r_cut=5.5, cutoff_mode="site", coulomb="ewald",
                       use_lrc=False, p_translate=0.5, p_volume=0.0,
                       dr_max=0.5, dphi_max=0.8)
    g = MolGibbsEnsemble(spce_system(16), params, p_transfer=0.4)
    with pytest.raises(ValueError, match="DIFFERENT truncated models"):
        g.init(jax.random.PRNGKey(0), boxes=(14.0, 22.0),
               n_init=(8, 8), n_chains=2)

    import dataclasses
    kl, nk, ksq = tune_parameters(22.0, 5.5, 1e-3)
    ok = dataclasses.replace(params, kappa_L=kl, nk=nk, ksq_max=ksq)
    g2 = MolGibbsEnsemble(spce_system(16), ok, p_transfer=0.4)
    st = g2.init(jax.random.PRNGKey(0), boxes=(14.0, 22.0),
                 n_init=(8, 8), n_chains=2)
    st, stats = g2.run_block(st, 50, drift_tol=1e-9)
    assert stats["acc_disp"] >= 0.0


def test_gibbs_mol_pressure_ideal_gas_exact():
    """pressure_fd: with eps = q = 0, P = N T / V exactly per box."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from metropolismontecarlo_tpu.mc.gibbs_mol import MolGibbsEnsemble
    from metropolismontecarlo_tpu.models.polyatomic import triatomic_system
    from metropolismontecarlo_tpu.models.system import RunParams

    params = RunParams(strict_min_image=False, temperature=1.4,
                       r_cut=2.5, cutoff_mode="site", coulomb="none",
                       p_translate=0.5, dr_max=0.5, dphi_max=0.5,
                       use_lrc=False, p_volume=0.0)
    g = MolGibbsEnsemble(triatomic_system(24, eps=0.0), params)
    st = g.init(jax.random.PRNGKey(0), boxes=(5.0, 7.0),
                n_init=(12, 18), n_chains=3)
    p = np.asarray(g.pressure_fd(st), np.float64)
    n = np.asarray(jnp.sum(st.active, axis=2), np.float64)
    v = np.asarray(st.box, np.float64) ** 3
    assert np.allclose(p, n * 1.4 / v, rtol=1e-9), p


def test_gibbs_mol_widom_works_ideal_bar_zero():
    """Ideal rigid rotor: insertion and deletion works are exactly zero
    in both boxes, so the two-sided BAR mu_ex is exactly zero and
    beta*mu reduces to ln(rho) — the closed-form anchor for the BAR
    mu-equality gate in docs/validation/run_gibbs_water.py."""
    from metropolismontecarlo_tpu.mc.fep import bar_mu_ex

    params = RunParams(strict_min_image=False, temperature=2.0,
                       r_cut=2.0, cutoff_mode="site", coulomb="none",
                       p_translate=0.7, dr_max=0.5, dphi_max=0.5,
                       use_lrc=False, p_volume=0.0)
    g = MolGibbsEnsemble(triatomic_system(16, eps=0.0), params,
                         p_transfer=0.5)
    st = g.init(jax.random.PRNGKey(0), boxes=(6.0, 8.0), n_init=(8, 4),
                n_chains=3)
    di, ov, dd = g.widom_works(st, jax.random.PRNGKey(1), 32, 32)
    assert di.shape == (3, 2, 32) and dd.shape == (3, 2, 32)
    assert np.allclose(np.asarray(di), 0.0) and not np.any(np.asarray(ov))
    assert np.allclose(np.asarray(dd), 0.0)
    assert bar_mu_ex(np.asarray(di[:, 0]), np.asarray(ov[:, 0]),
                     -np.asarray(dd[:, 0]), 2.0) == pytest.approx(0.0,
                                                                  abs=1e-12)


def test_gibbs_mol_widom_works_matches_boltzmann():
    """Interacting water: exp(-beta * du_insert) from widom_works must
    average to the same per-box Boltzmann factor widom_boltzmann
    computes (same key => same ghost poses), and deletion works must be
    finite with the exchange constants folded in."""
    from metropolismontecarlo_tpu.ops.ewald import tune_parameters

    kl, nk, ksq = tune_parameters(13.0, 4.5, 1e-3)
    params = RunParams(temperature=700.0, r_cut=4.5, cutoff_mode="site",
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       use_lrc=False, p_translate=0.5, p_volume=0.0,
                       dr_max=0.3, dphi_max=0.3, strict_min_image=False)
    g = MolGibbsEnsemble(spce_system(8), params, p_transfer=0.3)
    st = g.init(jax.random.PRNGKey(2), boxes=(11.0, 13.0), n_init=(6, 2),
                n_chains=2)
    key = jax.random.PRNGKey(3)
    bw = np.asarray(g.widom_boltzmann(st, key, 16), np.float64)
    di, ov, dd = g.widom_works(st, key, 16, 16)
    beta = 1.0 / params.temperature
    bw2 = np.mean(np.where(np.asarray(ov), 0.0,
                           np.exp(-beta * np.asarray(di, np.float64))),
                  axis=2)
    np.testing.assert_allclose(bw2, bw, rtol=1e-5)
    assert np.isfinite(np.asarray(dd)).all()
