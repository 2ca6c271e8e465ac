"""Molecular TMMC (flat-histogram muVT for rigid species):
  * eta = 0 trajectories are BIT-IDENTICAL to the plain molecular-GCMC
    build — the bias touches acceptance thresholds only;
  * ideal rigid rotor: ln Pi(N) = N ln(zV) - ln N! exactly (the
    Rao-Blackwellized deposits are deterministic per N);
  * SPC/E water + Ewald under a nonzero bias: carried energy AND
    structure factors survive biased insertions/deletions (drift
    invariant, the framework-wide anchor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import gammaln

from metropolismontecarlo_tpu.mc.gcmc_mol import make_gcmc_mol
from metropolismontecarlo_tpu.mc.tmmc import TMMCMol, lnpi_from_cmat
from metropolismontecarlo_tpu.models.polyatomic import triatomic_system
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system


def _lj_params(**kw):
    d = dict(strict_min_image=False, temperature=1.5, r_cut=2.5,
             cutoff_mode="site", coulomb="none", p_translate=0.5,
             dr_max=1.0, dphi_max=1.0, use_lrc=False)
    d.update(kw)
    return RunParams(**d)


def test_tmmc_mol_zero_bias_bit_identical_to_gcmc():
    """With eta = 0 the TMMC build must reproduce the plain GCMC build's
    trajectories bit-for-bit: same proposal stream, same acceptances,
    same state."""
    sys_ = triatomic_system(32)
    params = _lj_params()
    init_g, run_g, _ = make_gcmc_mol(sys_, params, activity=0.05,
                                     p_exchange=0.5)
    init_t, run_t, _ = make_gcmc_mol(sys_, params, activity=0.05,
                                     p_exchange=0.5, tmmc=True)
    st_g = init_g(jax.random.PRNGKey(7), box=6.0, n_init=10, n_chains=4)
    st_t = init_t(jax.random.PRNGKey(7), box=6.0, n_init=10, n_chains=4)
    st_g = run_g(st_g, 300)
    st_t, cmat, _ = run_t(st_t, np.zeros(33), 300)
    for a, b, name in zip(st_g, st_t, st_g._fields):
        assert jnp.array_equal(a, b), name
    # every step deposits exactly one unit of row mass per chain
    assert np.allclose(np.asarray(cmat).sum(axis=(1, 2)), 300.0)


def test_tmmc_mol_ideal_rotor_exact_lnpi():
    """eps = q = 0: deposits are deterministic per N, so the estimated
    ln Pi(N) equals N ln(zV) - ln N! to roundoff on the visited range."""
    z, box = 0.02, 6.0
    t = TMMCMol(triatomic_system(48, eps=0.0), _lj_params(), activity=z,
                p_exchange=0.6)
    st = t.init(jax.random.PRNGKey(1), box=box,
                n_init=np.linspace(0, 40, 64).astype(np.int32),
                n_chains=64)
    for _ in range(4):
        st, stats = t.run_block(st, 400, drift_tol=1e-10)
    lnpi, visited = lnpi_from_cmat(t.cmat)
    n = np.arange(len(lnpi), dtype=np.float64)
    exact = n * np.log(z * box**3) - gammaln(n + 1.0)
    fin = np.where(visited)[0]
    assert fin.size >= 20
    d = (lnpi[fin] - lnpi[fin[0]]) - (exact[fin] - exact[fin[0]])
    assert np.max(np.abs(d)) < 1e-9, np.max(np.abs(d))


def test_tmmc_mol_spce_bias_drift_invariant():
    """SPC/E + Ewald with a deliberately rough nonzero bias: biased
    exchanges must leave the carried energy and structure factors
    consistent with the dense recompute (f64)."""
    params = RunParams(strict_min_image=False, temperature=600.0,
                       r_cut=4.5, cutoff_mode="site", coulomb="ewald",
                       use_lrc=False, p_translate=0.5, dr_max=1.0,
                       dphi_max=0.8)
    t = TMMCMol(spce_system(12), params, activity=2e-4, p_exchange=0.5)
    t.eta = np.linspace(0.0, 6.0, 13)        # push toward high N
    st = t.init(jax.random.PRNGKey(3), box=10.0, n_init=4, n_chains=6)
    st, stats = t.run_block(st, 500, drift_tol=1e-9, update_bias=False)
    assert stats["sfac_err_max"] < 1e-8, stats
    assert stats["acc_insert"] > 0.0 or stats["acc_delete"] > 0.0, stats
    assert stats["n_max"] <= 12 and stats["n_min"] >= 0
