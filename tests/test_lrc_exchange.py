"""LJ long-range (tail) corrections in the fluctuating-N ensembles.

The reference carries LJ tail corrections only in NVT
(reference `Ewald/energy.jl:514-614`, `Ewald/auxillary.jl:16-35`);
this framework extends them to every exchange ensemble.  Since
U_lrc = (8 pi / 3V) sum_ss' N_s N_s' c_ss' is quadratic in the molecule
counts, every exchange delta is closed-form affine in N — these tests
gate that algebra at three levels:

1. EXACT coefficient identities: `ops/tail.mol_tail_coeff` vs
   `lrc_energy` on summed atom counts; every ensemble's exchange_const
   / flip delta vs brute-force lrc_energy differences.
2. EXACT distribution gate: at fixed N the tail term is
   configuration-INDEPENDENT, so P_lrc(N) = P_off(N) exp(-beta g N^2)
   / Z exactly — an LRC-off N-histogram reweighted by exp(-beta g N^2)
   predicts the LRC-on ensemble with no virial expansion at all.
3. Drift gates: the carried energy through exchanges, transfers and
   flips must equal the LRC-carrying dense recompute, in f64 and in the
   f32 the accelerator runs, for every exchange family.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.polyatomic import triatomic_system
from metropolismontecarlo_tpu.models.system import RunParams, System
from metropolismontecarlo_tpu.ops import tail


def _params(**kw):
    d = dict(strict_min_image=False, temperature=1.5, r_cut=2.5,
             cutoff_mode="site", coulomb="none", lj_shift="none",
             use_lrc=True, p_translate=0.5, dr_max=0.4, dphi_max=0.5)
    d.update(kw)
    return RunParams(**d)


def _lj_two_blocks(cap0, cap1, eps_t, sig_t):
    M = cap0 + cap1
    type_ids = np.zeros((M, 1), np.int32)
    type_ids[cap0:] = 1
    return System(n_mol=M, atoms_per_mol=1,
                  body=np.zeros((M, 1, 3)), masses=np.ones((M, 1)),
                  charges=np.zeros((M, 1)), type_ids=type_ids,
                  eps_table=np.asarray(eps_t, np.float64),
                  sig_table=np.asarray(sig_t, np.float64), name="lj2",
                  species=(("A", cap0, 1), ("B", cap1, 1)))


_ET2 = np.array([[0.8, 0.49], [0.49, 0.3]])
_ST2 = np.array([[1.1, 1.0], [1.0, 0.9]])


def _lrc_U(tvecs, counts, eps_t, sig_t, r_cut, vol):
    """Brute-force U_lrc from summed atom-type counts."""
    at = sum(np.asarray(t, np.float64) * n for t, n in zip(tvecs, counts))
    return float(tail.lrc_energy(
        jnp.asarray(at), jnp.asarray(eps_t, jnp.float64),
        jnp.asarray(sig_t, jnp.float64), r_cut, vol))


def test_mol_tail_coeff_matches_lrc_energy():
    """(8 pi/3V) sum N_s N_s' c_ss' == lrc_energy(sum N_s t_s) exactly,
    for random tables and multi-type molecules."""
    rng = np.random.default_rng(0)
    T = 3
    e = rng.uniform(0.1, 2.0, (T, T))
    eps_t = (e + e.T) / 2
    s = rng.uniform(0.8, 1.4, (T, T))
    sig_t = (s + s.T) / 2
    tvecs = [np.array([2.0, 1.0, 0.0]), np.array([0.0, 1.0, 3.0])]
    r_cut, vol = 2.5, 500.0
    c = np.array([[tail.mol_tail_coeff(ta, tb, eps_t, sig_t, r_cut)
                   for tb in tvecs] for ta in tvecs])
    for counts in [(1, 0), (0, 4), (3, 2), (7, 5)]:
        quad = tail.LRC_PREFACTOR / vol * sum(
            counts[a] * counts[b] * c[a, b]
            for a in range(2) for b in range(2))
        ref = _lrc_U(tvecs, counts, eps_t, sig_t, r_cut, vol)
        assert abs(quad - ref) < 1e-12 * max(1.0, abs(ref))


def test_exchange_consts_match_brute_force():
    """Every ensemble family's position-independent exchange delta ==
    the brute-force lrc_energy difference (single-species molecular,
    binary with cross terms, osmotic fixed-solvent, monatomic lrc_g,
    semigrand flip algebra)."""
    params = _params()
    box, vol = 7.0, 7.0**3

    # molecular single species (shared by gcmc_mol + gibbs_mol)
    from metropolismontecarlo_tpu.mc.gcmc_mol import make_mol_slots
    sys1 = triatomic_system(16)
    ms = make_mol_slots(sys1, params, jnp.float64)
    t1 = ms.ev.t_vec
    for n in (1, 5, 11):
        for dn in (1.0, -1.0):
            ec = float(ms.exchange_const(jnp.asarray(box),
                                         jnp.asarray(n), dn))
            ref = (_lrc_U([t1], [n + dn], sys1.eps_table, sys1.sig_table,
                          params.r_cut, vol)
                   - _lrc_U([t1], [n], sys1.eps_table, sys1.sig_table,
                            params.r_cut, vol))
            assert abs(ec - ref) < 1e-10 * max(1.0, abs(ec))

    # binary (shared by gcmc_binary + gibbs_binary): cross terms
    from metropolismontecarlo_tpu.mc.gcmc_binary import make_binary_slots
    sys2 = _lj_two_blocks(16, 16, _ET2, _ST2)
    mb = make_binary_slots(sys2, params, jnp.float64)
    t0, t1b = mb.evs[0].t_vec, mb.evs[1].t_vec
    for (n0, n1) in [(3, 5), (10, 0), (0, 4)]:
        for s in (0, 1):
            for dn in (1.0, -1.0):
                ec = float(mb.exchange_const(
                    jnp.asarray(box), jnp.asarray(n0), jnp.asarray(n1),
                    s, dn))
                cnew = (n0 + dn, n1) if s == 0 else (n0, n1 + dn)
                ref = (_lrc_U([t0, t1b], cnew, _ET2, _ST2,
                              params.r_cut, vol)
                       - _lrc_U([t0, t1b], (n0, n1), _ET2, _ST2,
                                params.r_cut, vol))
                assert abs(ec - ref) < 1e-10 * max(1.0, abs(ec))

    # semigrand flip delta: affine form vs brute force; identical
    # species -> exact cancellation (the cross-term structure gate)
    c00 = tail.mol_tail_coeff(t0, t0, _ET2, _ST2, params.r_cut)
    c01 = tail.mol_tail_coeff(t0, t1b, _ET2, _ST2, params.r_cut)
    c11 = tail.mol_tail_coeff(t1b, t1b, _ET2, _ST2, params.r_cut)
    g = tail.LRC_PREFACTOR / vol
    for (na, nb) in [(5, 3), (1, 9), (12, 1)]:
        d_ab = g * (-(2 * na - 1) * c00 + (2 * nb + 1) * c11
                    + 2 * (na - nb - 1) * c01)
        d_ba = g * ((2 * na + 1) * c00 - (2 * nb - 1) * c11
                    + 2 * (nb - na - 1) * c01)
        ref_ab = (_lrc_U([t0, t1b], (na - 1, nb + 1), _ET2, _ST2,
                         params.r_cut, vol)
                  - _lrc_U([t0, t1b], (na, nb), _ET2, _ST2,
                           params.r_cut, vol))
        ref_ba = (_lrc_U([t0, t1b], (na + 1, nb - 1), _ET2, _ST2,
                         params.r_cut, vol)
                  - _lrc_U([t0, t1b], (na, nb), _ET2, _ST2,
                           params.r_cut, vol))
        assert abs(d_ab - ref_ab) < 1e-12
        assert abs(d_ba - ref_ba) < 1e-12
    # identical species: delta must vanish identically
    ci = tail.mol_tail_coeff([1.0], [1.0], [[1.0]], [[1.1]], 2.5)
    assert abs(-(2 * 5 - 1) * ci + (2 * 3 + 1) * ci
               + 2 * (5 - 3 - 1) * ci) < 1e-14

    # monatomic lrc_g (shared by gcmc/tmmc/gibbs)
    from metropolismontecarlo_tpu.mc.gcmc import make_slot_lj
    sysm = lj_system(1)
    lrc_g = make_slot_lj(sysm, params, 8, jnp.float64)[3]
    gm = float(lrc_g(jnp.asarray(box)))
    tm = np.array([1.0])
    for n in (0, 3, 9):
        ref = (_lrc_U([tm], [n + 1], sysm.eps_table, sysm.sig_table,
                      params.r_cut, vol)
               - _lrc_U([tm], [n], sysm.eps_table, sysm.sig_table,
                        params.r_cut, vol))
        assert abs(gm * (2 * n + 1) - ref) < 1e-12

    # osmotic exchange_const is a local closure (not exposed); its
    # solute+fixed-solvent algebra is gated by the exact drift run in
    # test_lrc_drift_all_jnp_ensembles below


def test_lrc_off_when_shifted():
    """use_lrc with lj_shift='linear' silently disables the tail —
    consistent with models/energy (no tail exists for shifted LJ)."""
    from metropolismontecarlo_tpu.mc.gcmc import make_slot_lj
    lrc_g = make_slot_lj(lj_system(1), _params(lj_shift="linear"),
                         8, jnp.float64)[3]
    assert lrc_g is None
    from metropolismontecarlo_tpu.mc.widom import make_pose_eval
    ev = make_pose_eval(triatomic_system(4), _params(lj_shift="linear"),
                        None, None, jnp.float64)
    assert not ev.use_lrc
    assert float(ev.lrc_self_coeff(jnp.asarray(7.0))) == 0.0


def test_gcmc_lrc_exact_histogram_reweight():
    """The EXACT distribution gate: U_lrc is configuration-independent
    at fixed N, so P_on(N) = P_off(N) exp(-beta g N^2) / Z with NO
    approximation.  An LRC-off run's N-histogram reweighted by
    exp(-beta g N^2) must predict the LRC-on run's <N> and Var(N)."""
    jax.config.update("jax_enable_x64", True)
    from metropolismontecarlo_tpu.mc.gcmc import GCMC, n_counts

    # sigma near r_cut makes the tail LARGE relative to the pair well
    sysm = dataclasses.replace(
        lj_system(1), eps_table=np.full((1, 1), 0.5),
        sig_table=np.full((1, 1), 2.2))
    box, cap, z = 12.0, 64, 0.004
    kw = dict(temperature=1.5, r_cut=2.5, p_translate=0.4, dr_max=1.0)
    p_on = _params(**kw)
    p_off = _params(use_lrc=False, **kw)

    def run(params, seed):
        g = GCMC(sysm, params, activity=z, capacity=cap)
        st = g.init(jax.random.PRNGKey(seed), box=box, n_init=8,
                    n_chains=256)
        st, _ = g.run_block(st, 2500, drift_tol=1e-8)        # equil
        hist = np.zeros(cap + 1)
        for _ in range(6):
            st, stats = g.run_block(st, 1200, drift_tol=1e-8)
            hist += n_counts(st, cap)
        return hist

    hist_off = run(p_off, 0)
    hist_on = run(p_on, 1)

    # g(box) from the same closure the ensemble uses
    from metropolismontecarlo_tpu.mc.gcmc import make_slot_lj
    lrc_g = make_slot_lj(sysm, p_on, cap, jnp.float64)[3]
    g_val = float(lrc_g(jnp.asarray(box)))
    assert g_val < 0.0                      # attractive tail
    n = np.arange(cap + 1)
    beta = 1.0 / p_on.temperature
    logw = -beta * g_val * n.astype(np.float64) ** 2
    logw -= logw[hist_off > 0].max()
    w = np.where(hist_off > 0, hist_off * np.exp(logw), 0.0)
    mean_pred = float((n * w).sum() / w.sum())
    var_pred = float((n * n * w).sum() / w.sum() - mean_pred**2)
    mean_on = float((n * hist_on).sum() / hist_on.sum())
    var_on = float((n * n * hist_on).sum() / hist_on.sum() - mean_on**2)
    mean_off = float((n * hist_off).sum() / hist_off.sum())

    # the tail shift must be RESOLVED (several sigma of the gate tol)
    assert mean_pred - mean_off > 0.8, (mean_off, mean_pred)
    # ~1536 correlated chain-samples; allow a generous 4-sigma band
    tol = 4.0 * np.sqrt(var_on / 800.0) + 0.05
    assert abs(mean_on - mean_pred) < tol, \
        (mean_off, mean_pred, mean_on, tol)
    assert abs(var_on - var_pred) < 0.35 * var_pred + 0.5, \
        (var_pred, var_on)


def test_lrc_drift_all_jnp_ensembles():
    """Carried-energy == dense-recompute (both LRC-carrying) through
    exchanges/transfers/flips/volume moves — exact in f64 — for the
    osmotic, two-box and semigrand ensembles."""
    jax.config.update("jax_enable_x64", True)
    import os
    import sys as _s
    _s.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_gcmc_osmotic import lj_plus_trimer
    from metropolismontecarlo_tpu.mc.gcmc_osmotic import OsmoticGCMC
    from metropolismontecarlo_tpu.mc.gibbs import GibbsEnsemble
    from metropolismontecarlo_tpu.mc.gibbs_mol import MolGibbsEnsemble
    from metropolismontecarlo_tpu.mc.semigrand import Semigrand

    p = _params()
    g = OsmoticGCMC(lj_plus_trimer(12, 10), p, activity=0.01,
                    p_exchange=0.4)
    st = g.init(jax.random.PRNGKey(4), box=7.5, n_init=3, n_chains=4)
    g.run_block(st, 500, drift_tol=1e-9)

    gp = _params(temperature=1.1, p_translate=0.55, p_volume=0.02,
                 dr_max=0.3)
    gb = GibbsEnsemble(lj_system(1), gp, capacity=64, dv_max=0.05)
    st = gb.init(jax.random.PRNGKey(5), boxes=(6.0, 9.0),
                 n_init=(40, 12), n_chains=4)
    gb.run_block(st, 800, drift_tol=1e-9)

    gp2 = _params(temperature=1.8, p_volume=0.01, dr_max=0.3)
    gm = MolGibbsEnsemble(triatomic_system(24), gp2, dv_max=0.04,
                          p_transfer=0.3)
    st = gm.init(jax.random.PRNGKey(6), boxes=(6.0, 8.5),
                 n_init=(14, 5), n_chains=3)
    gm.run_block(st, 500, drift_tol=1e-9)

    sg = Semigrand(_lj_two_blocks(24, 24, _ET2, _ST2), p,
                   fugacity_ratio=2.0, p_flip=0.4)
    st = sg.init(jax.random.PRNGKey(7), box=7.0, n_a=8, n_b=8,
                 n_chains=4)
    sg.run_block(st, 500, drift_tol=1e-9)


def test_semigrand_lrc_identical_species_binomial():
    """Two identical interacting species with LRC on: the flip tail
    delta cancels EXACTLY (c00 = c01 = c11), so the closed-form
    Binomial(N, xi/(1+xi)) composition anchor must still hold — gating
    the cross-term algebra end to end."""
    jax.config.update("jax_enable_x64", True)
    from metropolismontecarlo_tpu.mc.semigrand import Semigrand

    eps_t = np.full((2, 2), 0.6)
    sig_t = np.full((2, 2), 1.0)
    sys2 = _lj_two_blocks(40, 40, eps_t, sig_t)
    xi = 2.0
    sg = Semigrand(sys2, _params(p_translate=0.4), fugacity_ratio=xi,
                   p_flip=0.5)
    st = sg.init(jax.random.PRNGKey(8), box=7.0, n_a=15, n_b=15,
                 n_chains=128)
    st, _ = sg.run_block(st, 1500, drift_tol=1e-9)           # equil
    means, varis = [], []
    for _ in range(4):
        st, stats = sg.run_block(st, 800, drift_tol=1e-9)
        means.append(stats["nb_mean"])
        varis.append(stats["nb_var"])
    n_tot, p_b = 30, xi / (1.0 + xi)
    exact_mean = n_tot * p_b
    exact_var = n_tot * p_b * (1 - p_b)
    got = float(np.mean(means))
    # 128 chains x 4 blocks; se ~ sqrt(var/(eff samples))
    se = np.sqrt(exact_var / 200.0)
    assert abs(got - exact_mean) < 4.0 * se + 0.1, (got, exact_mean)
    assert abs(float(np.mean(varis)) - exact_var) < 0.4 * exact_var + 0.3


def test_full_recompute_matches_energy_breakdown_lrc():
    """All slots active: the muVT app's LRC-carrying recompute equals
    the production energy model (which has carried NVT tail
    corrections since round 1) exactly."""
    jax.config.update("jax_enable_x64", True)
    from metropolismontecarlo_tpu.mc.gcmc_mol import MolGCMC
    from metropolismontecarlo_tpu.models.energy import energy_breakdown

    cap = 12
    sys1 = triatomic_system(cap)
    params = _params(temperature=2.0)
    g = MolGCMC(sys1, params, activity=0.02, p_exchange=0.3)
    st = g.init(jax.random.PRNGKey(9), box=6.5, n_init=cap, n_chains=2)
    e_app, _ = g.full_energy(st)
    A = sys1.n_atoms
    out = energy_breakdown(sys1, params, st.coords[0, :, :A].T,
                           st.com[0], jnp.asarray(6.5), None, None)
    assert abs(float(e_app[0]) - float(out["total"])) < 1e-8 \
        * max(1.0, abs(float(out["total"])))
    # and the lrc split itself is nonzero (the term is being tested)
    assert abs(float(out["lrc"])) > 1e-6


@pytest.mark.parametrize("path", ["mono", "mol", "binary", "gibbs",
                                  "flip"])
def test_lrc_exchange_drift_f32(path):
    """Every exchange family with LRC on, in float32 (the accelerator's
    precision): the carried deltas of exchanges/transfers/flips must
    match the LRC-carrying dense recompute to f32 roundoff."""
    f32 = jnp.float32
    if path == "mono":
        from metropolismontecarlo_tpu.mc.gcmc import GCMC
        g = GCMC(lj_system(1), _params(p_translate=0.4, temperature=1.2),
                 activity=0.05, capacity=64, dtype=f32)
        st = g.init(jax.random.PRNGKey(0), box=7.0, n_init=16,
                    n_chains=2)
        _, stats = g.run_block(st, 400)
    elif path == "mol":
        from metropolismontecarlo_tpu.mc.gcmc_mol import MolGCMC
        g = MolGCMC(triatomic_system(32), _params(temperature=2.0),
                    activity=0.02, p_exchange=0.3, dtype=f32)
        st = g.init(jax.random.PRNGKey(1), box=6.5, n_init=10,
                    n_chains=2)
        _, stats = g.run_block(st, 300)
    elif path == "binary":
        from metropolismontecarlo_tpu.mc.gcmc_binary import BinaryGCMC
        g = BinaryGCMC(_lj_two_blocks(32, 32, _ET2, _ST2),
                       _params(), activities=(0.05, 0.05),
                       p_exchange=0.4, dtype=f32)
        st = g.init(jax.random.PRNGKey(2), box=7.0, n_init=(8, 8),
                    n_chains=2)
        _, stats = g.run_block(st, 300)
    elif path == "gibbs":
        from metropolismontecarlo_tpu.mc.gibbs_mol import MolGibbsEnsemble
        g = MolGibbsEnsemble(
            triatomic_system(32),
            _params(temperature=1.8, p_volume=0.01, dr_max=0.3),
            dv_max=0.04, p_transfer=0.3, dtype=f32)
        st = g.init(jax.random.PRNGKey(3), boxes=(6.0, 8.5),
                    n_init=(20, 8), n_chains=2)
        _, stats = g.run_block(st, 300)
    else:
        from metropolismontecarlo_tpu.mc.semigrand import Semigrand
        g = Semigrand(_lj_two_blocks(40, 40, _ET2, _ST2), _params(),
                      fugacity_ratio=2.0, p_flip=0.3, dtype=f32)
        st = g.init(jax.random.PRNGKey(4), box=7.0, n_a=15, n_b=15,
                    n_chains=2)
        _, stats = g.run_block(st, 300)
    assert np.isfinite(stats["drift_max_rel"])
    assert stats["drift_max_rel"] < 1e-5, (path, stats["drift_max_rel"])


def test_tmmc_lnpi_shift_matches_tail():
    """TMMC with LRC: the collection-matrix deposits carry the tail
    through the UNBIASED ratios, so lnPi_on(N) - lnPi_off(N) must equal
    -beta g N^2 + const (exactly in expectation; Rao-Blackwellized
    deposits make short runs tight)."""
    jax.config.update("jax_enable_x64", True)
    from metropolismontecarlo_tpu.mc.tmmc import make_tmmc, lnpi_from_cmat

    sysm = dataclasses.replace(
        lj_system(1), eps_table=np.full((1, 1), 0.5),
        sig_table=np.full((1, 1), 2.2))
    box, cap, z = 12.0, 40, 0.004
    kw = dict(temperature=1.5, r_cut=2.5, p_translate=0.4, dr_max=1.0)

    def lnpi_run(params, seed):
        init, run_steps, _ = make_tmmc(sysm, params, z, cap)
        st = init(jax.random.PRNGKey(seed), box=box,
                  n_init=np.linspace(1, 24, 64).astype(int),
                  n_chains=64)
        eta = np.zeros(cap + 1)
        st, cmat, _ = run_steps(st, eta, 4000)
        lnpi, visited = lnpi_from_cmat(np.asarray(cmat).sum(0))
        return lnpi, visited

    lnpi_off, vis_off = lnpi_run(_params(use_lrc=False, **kw), 0)
    lnpi_on, vis_on = lnpi_run(_params(**kw), 1)
    from metropolismontecarlo_tpu.mc.gcmc import make_slot_lj
    g_val = float(make_slot_lj(sysm, _params(**kw), cap,
                               jnp.float64)[3](jnp.asarray(box)))
    beta = 1.0 / 1.5
    n = np.arange(cap + 1)
    # compare over well-visited slices only (intersection of the two
    # runs' contiguous visited ranges)
    both = vis_off & vis_on
    lo = 2
    hi = lo
    while hi < len(both) and both[hi]:
        hi += 1
    hi -= 3        # drop the sparsely-visited frontier bins (TMMC edge
    #                noise dominates the last few slices of any run)
    assert hi - lo >= 15, (lo, hi)          # a real comparison window
    diff = (lnpi_on - lnpi_off)[lo:hi]
    pred = (-beta * g_val * n.astype(np.float64) ** 2)[lo:hi]
    # free constant: compare shapes after removing the mean
    resid = (diff - diff.mean()) - (pred - pred.mean())
    assert np.max(np.abs(resid)) < 0.30, np.max(np.abs(resid))
