"""Semigrand ensemble (identity swaps at fixed total N): exact binomial
composition statistics — ideal AND fully interacting identical species —
plus the Ewald drift invariant through flips."""

import jax
import numpy as np
import pytest

from metropolismontecarlo_tpu.mc.semigrand import Semigrand
from metropolismontecarlo_tpu.models.system import RunParams, System
from metropolismontecarlo_tpu.models.water import spce_system


def two_block_lj(cap_a, cap_b, eps_a=1.0, eps_b=1.0, eps_ab=None,
                 sigma=1.0):
    """Monatomic A block + bent-triatomic B block (unequal widths
    exercise the ragged flip bookkeeping)."""
    from metropolismontecarlo_tpu.models.polyatomic import (
        bent_triatomic_body,
    )
    M, P = cap_a + cap_b, 3
    body = np.zeros((M, P, 3))
    body[cap_a:] = bent_triatomic_body()
    masses = np.zeros((M, P))
    masses[:cap_a, 0] = 1.0
    masses[cap_a:] = 1.0
    charges = np.zeros((M, P))
    type_ids = np.zeros((M, P), np.int32)
    type_ids[cap_a:] = 1
    ab = np.sqrt(eps_a * eps_b) if eps_ab is None else eps_ab
    eps_t = np.array([[eps_a, ab], [ab, eps_b]])
    sig_t = np.full((2, 2), sigma)
    return System(n_mol=M, atoms_per_mol=P, body=body, masses=masses,
                  charges=charges, type_ids=type_ids, eps_table=eps_t,
                  sig_table=sig_t, name="sg-lj",
                  species=(("A", cap_a, 1), ("B", cap_b, 3)))


def water_two_blocks(cap_a, cap_b):
    w = spce_system(cap_a + cap_b)
    return System(n_mol=cap_a + cap_b, atoms_per_mol=3, body=w.body,
                  masses=w.masses, charges=w.charges,
                  type_ids=w.type_ids, eps_table=w.eps_table,
                  sig_table=w.sig_table, name="sg-spce",
                  species=(("wA", cap_a, 3), ("wB", cap_b, 3)))


def test_semigrand_ideal_binomial():
    """Both species non-interacting, xi = 3: each of the N molecules is
    independently species B with probability xi/(1+xi) = 3/4 —
    Binomial(N, 3/4) mean and variance in closed form; total N strictly
    conserved through flips."""
    n_tot, xi = 48, 3.0
    sysI = two_block_lj(64, 64, eps_a=0.0, eps_b=0.0, eps_ab=0.0)
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.0,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=1.0, dphi_max=1.0, use_lrc=False)
    g = Semigrand(sysI, params, fugacity_ratio=xi, p_flip=0.6)
    st = g.init(jax.random.PRNGKey(0), box=8.0, n_a=24, n_b=24,
                n_chains=192)
    st, _ = g.run_block(st, 1500)
    means, varis = [], []
    for _ in range(6):
        st, stats = g.run_block(st, 400, drift_tol=1e-10)
        means.append(stats["nb_mean"])
        varis.append(stats["nb_var"])
        assert stats["n_tot_mean"] == n_tot
    p = xi / (1.0 + xi)
    assert np.mean(means) == pytest.approx(n_tot * p, rel=0.02), means
    assert np.mean(varis) == pytest.approx(n_tot * p * (1 - p),
                                           rel=0.15), varis


def test_semigrand_identical_species_binomial_with_interactions():
    """A and B physically identical (both SPC/E) with FULL Ewald
    interactions, xi = 2: relabeling cannot change the physics, so the
    composition is EXACTLY Binomial(N, 2/3) at any interaction strength
    — a closed-form statistical anchor for the flip acceptance — while
    the carried energy and structure factors stay drift-exact."""
    n_tot, xi = 12, 2.0
    params = RunParams(temperature=600.0, r_cut=8.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=1.0, dphi_max=0.7)
    g = Semigrand(water_two_blocks(20, 20), params, fugacity_ratio=xi,
                  p_flip=0.5, n_orient=4)
    st = g.init(jax.random.PRNGKey(1), box=20.0, n_a=6, n_b=6,
                n_chains=64)
    st, _ = g.run_block(st, 1200)
    means, varis = [], []
    flips = 0.0
    for _ in range(5):
        st, stats = g.run_block(st, 500, drift_tol=1e-9)
        assert stats["sfac_err_max"] < 1e-8, stats
        means.append(stats["nb_mean"])
        varis.append(stats["nb_var"])
        flips += stats["acc_flip_ab"] + stats["acc_flip_ba"]
    assert flips > 0.0
    p = xi / (1.0 + xi)
    assert np.mean(means) == pytest.approx(n_tot * p, rel=0.04), means
    assert np.mean(varis) == pytest.approx(n_tot * p * (1 - p),
                                           rel=0.25), varis


def test_semigrand_interacting_flip_drift():
    """Unequal species (monatomic vs trimer, different LJ): flips change
    the energy landscape for real; the drift invariant must hold."""
    params = RunParams(strict_min_image=False, temperature=3.0, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=0.4, dphi_max=1.0, use_lrc=False)
    g = Semigrand(two_block_lj(40, 40, eps_a=1.0, eps_b=0.6), params,
                  fugacity_ratio=1.5, p_flip=0.4, n_orient=4)
    st = g.init(jax.random.PRNGKey(2), box=6.0, n_a=16, n_b=8,
                n_chains=64)
    flips = 0.0
    for _ in range(3):
        st, stats = g.run_block(st, 800, drift_tol=1e-10)
        flips += stats["acc_flip_ab"] + stats["acc_flip_ba"]
        assert stats["n_tot_mean"] == 24
    assert flips > 0.0, stats


def test_semigrand_validation_guards():
    params = RunParams(temperature=300.0, r_cut=5.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False)
    with pytest.raises(ValueError, match="two species"):
        Semigrand(spce_system(8), params, fugacity_ratio=1.0)
    g = Semigrand(water_two_blocks(8, 8), params, fugacity_ratio=1.0)
    with pytest.raises(ValueError, match="capacity"):
        g.init(jax.random.PRNGKey(0), box=12.0, n_a=6, n_b=6, n_chains=2)
