"""Molecular grand-canonical MC: exact model consistency, Poisson
statistics for the ideal rigid rotor, Widom cross-validation for an
interacting triatomic, and the Ewald drift invariant through
insertions/deletions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.mc.gcmc_mol import MolGCMC
from metropolismontecarlo_tpu.models.polyatomic import triatomic_system
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system


def _water_params(**kw):
    d = dict(temperature=500.0, r_cut=10.0, cutoff_mode="site",
             coulomb="ewald", use_lrc=False, p_translate=0.5,
             dr_max=1.0, dphi_max=0.6)
    d.update(kw)
    return RunParams(**d)


def test_gcmc_mol_full_energy_matches_model():
    """All slots active: the app's masked pose-sum recompute equals the
    production energy model (models/energy.energy_breakdown) exactly —
    LJ + Ewald real + reciprocal + self + intra, and again after a block
    of pure NVT moves (p_exchange = 0 keeps every slot active)."""
    from metropolismontecarlo_tpu.models.energy import energy_breakdown
    from metropolismontecarlo_tpu.ops.ewald import make_kvectors

    sys8 = spce_system(8)
    params = _water_params(temperature=300.0, r_cut=5.0)
    g = MolGCMC(sys8, params, activity=1e-4, p_exchange=0.0)
    st = g.init(jax.random.PRNGKey(0), box=12.0, n_init=8, n_chains=3)
    kv, kw = make_kvectors(params.nk, params.ksq_max)

    def model_total(c):
        A = sys8.n_atoms
        out = energy_breakdown(sys8, params, st.coords[c, :, :A].T,
                               st.com[c], st.box[c], kv, kw)
        return float(out["total"])

    for c in range(3):
        assert float(st.energy[c]) == pytest.approx(model_total(c),
                                                    rel=1e-9)

    st, stats = g.run_block(st, 400, drift_tol=1e-9)
    assert stats["acc_trans"] > 0.0 and stats["acc_rot"] > 0.0
    for c in range(3):
        assert float(st.energy[c]) == pytest.approx(model_total(c),
                                                    rel=1e-9)


def test_gcmc_mol_ideal_rigid_rotor_poisson():
    """eps = q = 0: the molecular muVT number distribution is
    Poisson(z V) — mean and variance — which exercises the quaternion
    and slot bookkeeping with zero interactions."""
    z, box = 0.02, 10.0
    params = RunParams(strict_min_image=False, temperature=1.5, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=1.0, dphi_max=1.0, use_lrc=False)
    g = MolGCMC(triatomic_system(64, eps=0.0), params, activity=z,
                p_exchange=0.6)
    st = g.init(jax.random.PRNGKey(0), box=box, n_init=20, n_chains=256)
    st, _ = g.run_block(st, 2500)
    means, varis = [], []
    for _ in range(8):
        st, stats = g.run_block(st, 700, drift_tol=1e-10)
        means.append(stats["n_mean"])
        varis.append(stats["n_var"])
        assert stats["full_frac"] == 0.0
    zv = z * box**3
    assert np.mean(means) == pytest.approx(zv, rel=0.03), means
    assert np.mean(varis) == pytest.approx(zv, rel=0.12), varis


def test_gcmc_mol_activity_ladder():
    """Per-chain ACTIVITY LADDERS for molecular muVT: (a) a ladder with
    identical entries is bit-identical to the scalar build; (b) ideal
    rigid rotors at an 8-rung ladder hit N ~ Poisson(z_i V) per rung."""
    from metropolismontecarlo_tpu.mc.gcmc_mol import make_gcmc_mol

    params = RunParams(strict_min_image=False, temperature=1.5,
                       r_cut=2.5, cutoff_mode="site", coulomb="none",
                       p_translate=0.5, dr_max=1.0, dphi_max=1.0,
                       use_lrc=False)
    sys_ = triatomic_system(32)
    init_s, run_s, _ = make_gcmc_mol(sys_, params, activity=0.05,
                                     p_exchange=0.5)
    init_l, run_l, _ = make_gcmc_mol(sys_, params,
                                     activity=np.full(4, 0.05),
                                     p_exchange=0.5)
    st_s = init_s(jax.random.PRNGKey(7), box=6.0, n_init=10, n_chains=4)
    st_l = init_l(jax.random.PRNGKey(7), box=6.0, n_init=10, n_chains=4)
    st_s = run_s(st_s, 300)
    st_l = run_l(st_l, 300)
    for a, b, name in zip(st_s, st_l, st_s._fields):
        assert jnp.array_equal(a, b), name

    # 8-rung ideal-rotor isotherm in ONE run: 32 chains per rung
    box = 10.0
    zs = np.geomspace(0.005, 0.04, 8)
    ladder = np.repeat(zs, 32)
    g = MolGCMC(triatomic_system(64, eps=0.0), params, activity=ladder,
                p_exchange=0.6)
    st = g.init(jax.random.PRNGKey(1), box=box,
                n_init=np.minimum((zs[None, :] * box**3)
                                  .astype(np.int32), 60)
                .repeat(32).reshape(-1),
                n_chains=256)
    st, _ = g.run_block(st, 2000)
    st, stats = g.run_block(st, 2500, drift_tol=1e-10)
    n = np.asarray(jnp.sum(st.active, axis=1), np.float64).reshape(8, 32)
    for i, z in enumerate(zs):
        assert n[i].mean() == pytest.approx(z * box**3, rel=0.12), \
            (i, z, n[i].mean())


def test_gcmc_mol_widom_chemical_potential_consistency():
    """Interacting LJ triatomic at supercritical T: beta mu_ex =
    ln(z / <rho>) from molecular GCMC must agree with the Widom
    machinery on an NVT run of the main driver at the sampled density
    (two independent samplers, one energy model)."""
    z, box, t = 0.05, 6.0, 3.0
    params = RunParams(strict_min_image=False, temperature=t, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=0.5, dphi_max=1.0, use_lrc=False)
    g = MolGCMC(triatomic_system(48), params, activity=z, p_exchange=0.4)
    st = g.init(jax.random.PRNGKey(1), box=box, n_init=10, n_chains=128)
    st, _ = g.run_block(st, 4000)
    n_means = []
    for _ in range(5):
        st, stats = g.run_block(st, 1000, drift_tol=1e-10)
        n_means.append(stats["n_mean"])
        assert stats["full_frac"] == 0.0
    n_mean = float(np.mean(n_means))
    rho = n_mean / box**3
    bmu_gcmc = np.log(z / rho)

    from metropolismontecarlo_tpu.io.configs import cubic_lattice
    from metropolismontecarlo_tpu.mc.driver import MonteCarlo

    n = int(round(n_mean))
    nvt = RunParams(strict_min_image=False, temperature=t, r_cut=2.5,
                    cutoff_mode="site", coulomb="none", p_translate=0.5,
                    dr_max=0.5, dphi_max=1.0, use_lrc=False)
    mc = MonteCarlo(triatomic_system(n), nvt, dtype=jnp.float64,
                    recompute_chunk=16)
    state = mc.init_state(jax.random.PRNGKey(2), cubic_lattice(n, box),
                          box=box, n_chains=64)
    state = mc.run_steps(state, 250, False)
    bsum, cnt = 0.0, 0
    for i in range(5):
        state = mc.run_steps(state, 50, False)
        w = mc.widom(state, jax.random.PRNGKey(100 + i), n_insertions=256)
        bsum += float(jnp.mean(w["boltzmann_mean"]))
        cnt += 1
    bmu_widom = -np.log(bsum / cnt)
    # rounding <N> to an integer shifts rho by ~2%, worth ~0.03 in b*mu
    assert bmu_gcmc == pytest.approx(bmu_widom, abs=0.15), \
        (bmu_gcmc, bmu_widom, n_mean)


def test_gcmc_mol_spce_ewald_drift_through_exchanges():
    """SPC/E water with full Ewald: the carried energy AND the carried
    structure factors must match a dense recompute after thousands of
    mixed displacement/rotation/insertion/deletion steps — the framework
    drift invariant extended to exchange moves."""
    z = 2.5e-3
    params = _water_params()
    g = MolGCMC(spce_system(27), params, activity=z, p_exchange=0.5)
    st = g.init(jax.random.PRNGKey(3), box=20.0, n_init=14, n_chains=16)
    ins = dels = 0.0
    for _ in range(2):
        st, stats = g.run_block(st, 600, drift_tol=1e-9)
        assert stats["sfac_err_max"] < 1e-8, stats
        ins += stats["acc_insert"]
        dels += stats["acc_delete"]
    # the invariant only bites if exchanges actually happen
    assert ins > 0.0 and dels > 0.0, (ins, dels)
    assert 2.0 < stats["n_mean"] < 27.0, stats


def test_gcmc_mol_validation_guards():
    # use_lrc=True is SUPPORTED since round 5 (tail corrections in the
    # exchange rules); building must succeed
    MolGCMC(spce_system(8), _water_params(use_lrc=True), activity=1e-4)
    with pytest.raises(ValueError, match="minimum-image"):
        g = MolGCMC(spce_system(8), _water_params(), activity=1e-4)
        g.init(jax.random.PRNGKey(0), box=12.0, n_init=4, n_chains=2)


def test_gcmc_mol_orientational_bias_same_ensemble():
    """n_orient = 8 (Rosenbluth orientational bias) must sample the SAME
    muVT distribution as the unbiased n_orient = 1 sampler — identical
    <N> and <E> at identical activity; only the acceptance rate may
    change.  This is the exactness property of configurational-bias MC."""
    z, box, t = 0.05, 6.0, 3.0
    params = RunParams(strict_min_image=False, temperature=t, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=0.5, dphi_max=1.0, use_lrc=False)
    sysT = triatomic_system(48)
    results = {}
    for k in (1, 8):
        g = MolGCMC(sysT, params, activity=z, p_exchange=0.4, n_orient=k)
        st = g.init(jax.random.PRNGKey(10 + k), box=box, n_init=10,
                    n_chains=96)
        st, _ = g.run_block(st, 3000)
        ns, es = [], []
        for _ in range(4):
            st, stats = g.run_block(st, 800, drift_tol=1e-10)
            ns.append(stats["n_mean"])
            es.append(stats["energy_mean"])
            assert stats["full_frac"] == 0.0
        results[k] = (np.mean(ns), np.mean(es), stats["acc_insert"])
    n1, e1, _ = results[1]
    n8, e8, _ = results[8]
    assert n8 == pytest.approx(n1, rel=0.05), results
    assert e8 == pytest.approx(e1, rel=0.15), results


def test_gcmc_mol_orientational_bias_ewald_drift():
    """Biased exchanges keep the carried energy and structure factors
    exact (the selected trial's bookkeeping matches dense recomputes)."""
    params = _water_params()
    g = MolGCMC(spce_system(27), params, activity=2.5e-3, p_exchange=0.5,
                n_orient=6)
    st = g.init(jax.random.PRNGKey(4), box=20.0, n_init=14, n_chains=12)
    ins = dels = 0.0
    for _ in range(2):
        st, stats = g.run_block(st, 500, drift_tol=1e-9)
        assert stats["sfac_err_max"] < 1e-8, stats
        ins += stats["acc_insert"]
        dels += stats["acc_delete"]
    assert ins > 0.0 and dels > 0.0, (ins, dels)


def test_gcmc_mol_checkpoint_resume(tmp_path):
    """Exact-trajectory resume: 200 steps + checkpoint + 200 steps is
    BITWISE identical to 400 straight steps (keys, counters, structure
    factors all round-trip)."""
    from metropolismontecarlo_tpu.io.checkpoint import (
        load_ensemble_state,
        save_ensemble_state,
    )
    from metropolismontecarlo_tpu.mc.gcmc_mol import MolGCMCState

    params = _water_params()
    g = MolGCMC(spce_system(16), params, activity=2e-3, p_exchange=0.5)
    st = g.init(jax.random.PRNGKey(11), box=20.0, n_init=8, n_chains=4)
    straight = g.run_steps(st, 400)
    half = g.run_steps(st, 200)
    path = str(tmp_path / "ck.npz")
    save_ensemble_state(path, half, {"block": 3})
    loaded, meta = load_ensemble_state(path, MolGCMCState)
    assert int(meta["block"]) == 3
    resumed = g.run_steps(
        MolGCMCState(*[jnp.asarray(x) for x in loaded]), 200)
    for f in MolGCMCState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(straight, f)),
                                      np.asarray(getattr(resumed, f)), f)

    from metropolismontecarlo_tpu.mc.gibbs_mol import MolGibbsState
    with pytest.raises(ValueError, match="MolGibbsState"):
        load_ensemble_state(path, MolGibbsState)


def test_gcmc_mol_pose_bias_same_ensemble():
    """bias="pose" (k full uniform poses: positional/cavity bias, the
    dense-phase workhorse) must sample the SAME muVT distribution as
    the unbiased sampler — same <N>, <E>; only acceptance changes."""
    z, box, t = 0.05, 6.0, 3.0
    params = RunParams(strict_min_image=False, temperature=t, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=0.5, dphi_max=1.0, use_lrc=False)
    sysT = triatomic_system(48)
    results = {}
    for k in (1, 8):
        g = MolGCMC(sysT, params, activity=z, p_exchange=0.4, n_orient=k,
                    bias="pose")
        st = g.init(jax.random.PRNGKey(30 + k), box=box, n_init=10,
                    n_chains=96)
        st, _ = g.run_block(st, 3000)
        ns, es = [], []
        for _ in range(4):
            st, stats = g.run_block(st, 800, drift_tol=1e-10)
            ns.append(stats["n_mean"])
            es.append(stats["energy_mean"])
            assert stats["full_frac"] == 0.0
        results[k] = (np.mean(ns), np.mean(es))
    n1, e1 = results[1]
    n8, e8 = results[8]
    assert n8 == pytest.approx(n1, rel=0.05), results
    assert e8 == pytest.approx(e1, rel=0.15), results


def test_gcmc_mol_pose_bias_ewald_drift():
    """Cavity-biased exchanges keep the carried energy and structure
    factors exact through the full Ewald bookkeeping."""
    params = _water_params()
    g = MolGCMC(spce_system(27), params, activity=2.5e-3, p_exchange=0.5,
                n_orient=6, bias="pose")
    st = g.init(jax.random.PRNGKey(4), box=20.0, n_init=14, n_chains=12)
    ins = dels = 0.0
    for _ in range(2):
        st, stats = g.run_block(st, 500, drift_tol=1e-9)
        assert stats["sfac_err_max"] < 1e-8, stats
        ins += stats["acc_insert"]
        dels += stats["acc_delete"]
    assert ins > 0.0 and dels > 0.0, (ins, dels)
