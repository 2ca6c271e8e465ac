"""Gibbs-ensemble MC: exact binomial partitioning, density equality,
vapor-liquid coexistence with chemical-potential equality, drift."""

import jax
import numpy as np
import pytest

from metropolismontecarlo_tpu.mc.gibbs import GibbsEnsemble
from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.system import RunParams


def test_gibbs_ideal_gas_binomial():
    """eps = 0, volume moves off, V1 = V2: every particle is
    independently in box 1 with probability 1/2, so N1 ~ Binomial(N, 1/2)
    — mean N/2 and variance N/4 in closed form."""
    n_tot = 40
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.0,
                       cutoff_mode="site", coulomb="none", p_translate=0.3,
                       p_volume=0.0, dr_max=1.0, use_lrc=False)
    g = GibbsEnsemble(lj_system(1, eps=0.0), params, capacity=64)
    st = g.init(jax.random.PRNGKey(0), boxes=(8.0, 8.0),
                n_init=(20, 20), n_chains=256)
    st, _ = g.run_block(st, 2000)
    n1 = []
    for _ in range(8):
        st, stats = g.run_block(st, 500, drift_tol=1e-10)
        n1.append(np.asarray(st.active[:, 0].sum(axis=1), np.float64))
    n1 = np.concatenate(n1)
    assert n1.mean() == pytest.approx(n_tot / 2, rel=0.03), n1.mean()
    assert n1.var() == pytest.approx(n_tot / 4, rel=0.15), n1.var()
    # total N strictly conserved
    n_all = np.asarray(st.active.sum(axis=(1, 2)))
    assert (n_all == n_tot).all()


def test_gibbs_ideal_gas_density_equality():
    """eps = 0 with volume AND transfer moves: the two boxes must reach
    equal mean densities (the ensemble's stationarity condition)."""
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.0,
                       cutoff_mode="site", coulomb="none", p_translate=0.3,
                       p_volume=0.1, dr_max=1.0, use_lrc=False)
    g = GibbsEnsemble(lj_system(1, eps=0.0), params, capacity=64,
                      dv_max=0.05)
    st = g.init(jax.random.PRNGKey(1), boxes=(10.0, 7.0),
                n_init=(30, 10), n_chains=128)
    st, _ = g.run_block(st, 3000)
    r1, r2 = [], []
    for _ in range(6):
        st, stats = g.run_block(st, 600, drift_tol=1e-10)
        n = np.asarray(st.active.sum(axis=2), np.float64)
        v = np.asarray(st.box, np.float64) ** 3
        r1.append((n[:, 0] / v[:, 0]).mean())
        r2.append((n[:, 1] / v[:, 1]).mean())
    m1, m2 = np.mean(r1), np.mean(r2)
    assert m1 == pytest.approx(m2, rel=0.1), (m1, m2)


@pytest.mark.slow
def test_gibbs_lj_coexistence_mu_equality():
    """Subcritical LJ (T* = 1.0, cut at 2.5 sigma): chains phase-separate
    into a dense liquid and dilute vapor, and the full chemical
    potentials beta mu = ln rho - ln<exp(-beta dU_test)> agree between
    the boxes — the defining property of the Gibbs ensemble, checked
    with independent per-box Widom insertions."""
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.6,
                       p_volume=0.02, dr_max=0.35, use_lrc=False)
    g = GibbsEnsemble(lj_system(1), params, capacity=256, dv_max=0.03)
    st = g.init(jax.random.PRNGKey(2), boxes=(7.13, 7.13),
                n_init=(108, 108), n_chains=8)
    st, _ = g.run_block(st, 60_000)                       # phase split
    rho_l, rho_v, b_l, b_v = [], [], [], []
    for i in range(6):
        st, stats = g.run_block(st, 10_000, drift_tol=1e-9)
        rho_l.append(stats["rho_liq"])
        rho_v.append(stats["rho_vap"])
        bw = np.asarray(g.widom_boltzmann(st, jax.random.PRNGKey(50 + i),
                                          1024), np.float64)   # (C, 2)
        rho = np.asarray(st.active.sum(axis=2), np.float64) \
            / np.asarray(st.box, np.float64) ** 3
        liq = np.argmax(rho, axis=1)
        idx = np.arange(rho.shape[0])
        b_l.append(bw[idx, liq].mean())
        b_v.append(bw[idx, 1 - liq].mean())
    rl, rv = np.mean(rho_l), np.mean(rho_v)
    assert rl > 0.5, (rl, rv)
    assert rv < 0.15, (rl, rv)
    # mu equality: beta mu = ln rho - ln B per phase
    bmu_l = np.log(rl) - np.log(np.mean(b_l))
    bmu_v = np.log(rv) - np.log(np.mean(b_v))
    assert bmu_l == pytest.approx(bmu_v, abs=0.25), (bmu_l, bmu_v)
