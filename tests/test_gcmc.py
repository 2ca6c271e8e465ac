"""Grand-canonical MC: exact Poisson statistics, Widom cross-validation,
and the carried-energy drift invariant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.mc.gcmc import GCMC
from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.system import RunParams


def test_gcmc_ideal_gas_poisson():
    """eps = 0: the muVT number distribution is Poisson(z V) — mean and
    variance both equal z V (closed form; capacity 64 truncates a
    Poisson(20) tail at ~1e-15)."""
    z, box = 0.02, 10.0
    params = RunParams(strict_min_image=False, temperature=1.5, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.3,
                       dr_max=1.0, use_lrc=False)
    g = GCMC(lj_system(1, eps=0.0), params, activity=z, capacity=64)
    st = g.init(jax.random.PRNGKey(0), box=box, n_init=20, n_chains=256)
    st, _ = g.run_block(st, 3000)            # equilibrate N
    means, varis = [], []
    for _ in range(8):
        st, stats = g.run_block(st, 800, drift_tol=1e-10)
        means.append(stats["n_mean"])
        varis.append(stats["n_var"])
        assert stats["full_frac"] == 0.0
    zv = z * box**3
    assert np.mean(means) == pytest.approx(zv, rel=0.03), means
    assert np.mean(varis) == pytest.approx(zv, rel=0.12), varis


def test_gcmc_widom_chemical_potential_consistency():
    """Interacting LJ at supercritical T: the activity relation
    beta mu_ex = ln(z / <rho>) from GCMC must agree with the Widom
    machinery (an independent implementation, mc/widom.py) evaluated on
    an NVT run at the sampled density."""
    z, box, t = 0.25, 6.0, 2.0
    params = RunParams(strict_min_image=False, temperature=t, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=0.4, use_lrc=False)
    g = GCMC(lj_system(1), params, activity=z, capacity=128)
    st = g.init(jax.random.PRNGKey(1), box=box, n_init=48, n_chains=128)
    st, _ = g.run_block(st, 6000)
    n_means = []
    for _ in range(6):
        st, stats = g.run_block(st, 1500, drift_tol=1e-10)
        n_means.append(stats["n_mean"])
        assert stats["full_frac"] == 0.0
    n_mean = float(np.mean(n_means))
    rho = n_mean / box**3
    bmu_gcmc = np.log(z / rho)

    # independent NVT + Widom at the same density (rounded N)
    from metropolismontecarlo_tpu.io.configs import cubic_lattice
    from metropolismontecarlo_tpu.mc.driver import MonteCarlo

    n = int(round(n_mean))
    nvt = RunParams(strict_min_image=False, temperature=t, r_cut=2.5,
                    cutoff_mode="site", coulomb="none", p_translate=1.0,
                    dr_max=0.4, use_lrc=False)
    mc = MonteCarlo(lj_system(n), nvt, dtype=jnp.float64,
                    recompute_chunk=16)
    state = mc.init_state(jax.random.PRNGKey(2), cubic_lattice(n, box),
                          box=box, n_chains=64)
    state = mc.run_steps(state, 300, False)
    bsum, cnt = 0.0, 0
    for i in range(6):
        state = mc.run_steps(state, 60, False)
        w = mc.widom(state, jax.random.PRNGKey(100 + i), n_insertions=256)
        bsum += float(jnp.mean(w["boltzmann_mean"]))
        cnt += 1
    bmu_widom = -np.log(bsum / cnt)
    # rounding <N> to integer shifts rho by <1%, worth ~0.02 in beta mu
    assert bmu_gcmc == pytest.approx(bmu_widom, abs=0.12), \
        (bmu_gcmc, bmu_widom, n_mean)


def test_gcmc_capacity_guard_and_validation():
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", use_lrc=False)
    # use_lrc=True is SUPPORTED since round 5 (tail corrections in the
    # exchange rules — tests/test_lrc_exchange.py); building must succeed
    GCMC(lj_system(1),
         RunParams(strict_min_image=False, temperature=1.0, r_cut=2.5,
                   cutoff_mode="site", coulomb="none", use_lrc=True),
         activity=0.1, capacity=8)
    g = GCMC(lj_system(1), params, activity=0.1, capacity=8)
    with pytest.raises(ValueError, match="capacity"):
        g.init(jax.random.PRNGKey(0), box=5.0, n_init=9, n_chains=2)


def test_gcmc_reweight_poisson_exact():
    """Activity reweighting is EXACT on the ideal gas: a Poisson(z0 V)
    histogram reweighted to z1 must be Poisson(z1 V) in closed form
    (P(N) ~ z^N / N!), independent of any sampling."""
    from metropolismontecarlo_tpu.mc.gcmc import reweight_activity

    z0, z1, vol, cap = 0.02, 0.035, 1000.0, 128
    lam0 = z0 * vol
    n = np.arange(cap + 1)
    logpmf = n * np.log(lam0) - lam0 - np.cumsum(
        np.concatenate([[0.0], np.log(np.maximum(n[1:], 1))]))
    hist = np.exp(logpmf) * 1e12
    out = reweight_activity(hist, z0, z1)
    assert out["n_mean"] == pytest.approx(z1 * vol, rel=1e-6), out
    assert out["n_var"] == pytest.approx(z1 * vol, rel=1e-6), out
    assert out["ess"] > 0.0


def test_gcmc_reweight_matches_direct_run():
    """P(N) sampled at z0 and reweighted to z1 must predict the <N> of a
    direct muVT run at z1 (interacting LJ, supercritical)."""
    from metropolismontecarlo_tpu.mc.gcmc import n_counts, reweight_activity

    box, t = 6.0, 2.0
    z0, z1 = 0.25, 0.32
    params = RunParams(strict_min_image=False, temperature=t, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.5,
                       dr_max=0.4, use_lrc=False)
    g = GCMC(lj_system(1), params, activity=z0, capacity=128)
    st = g.init(jax.random.PRNGKey(3), box=box, n_init=48, n_chains=128)
    st, _ = g.run_block(st, 6000)
    hist = np.zeros(129, np.int64)
    for _ in range(6):
        st, stats = g.run_block(st, 1200, drift_tol=1e-10)
        hist += n_counts(st, 128)
    out = reweight_activity(hist, z0, z1)
    assert out["ess"] > 0.05, out

    gd = GCMC(lj_system(1), params, activity=z1, capacity=128)
    sd = gd.init(jax.random.PRNGKey(4), box=box, n_init=48, n_chains=128)
    sd, _ = gd.run_block(sd, 6000)
    direct = []
    for _ in range(4):
        sd, stats = gd.run_block(sd, 1200, drift_tol=1e-10)
        direct.append(stats["n_mean"])
    assert out["n_mean"] == pytest.approx(np.mean(direct), rel=0.04), \
        (out, np.mean(direct))


def test_gcmc_reweight_empty_histogram_raises():
    from metropolismontecarlo_tpu.mc.gcmc import reweight_activity

    with pytest.raises(ValueError, match="empty"):
        reweight_activity(np.zeros(64), 0.1, 0.2)


def test_gcmc_activity_ladder_per_chain_poisson():
    """(n_chains,) activity ladder: each chain is its own muVT ensemble,
    so with eps = 0 the per-rung group means must match Poisson(z_k V)
    rung by rung — in ONE compiled run."""
    box = 8.0
    zs = np.asarray([0.01, 0.02, 0.04, 0.08])
    per = 64
    ladder = np.repeat(zs, per)              # (256,) chain activities
    params = RunParams(strict_min_image=False, temperature=1.5, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.3,
                       dr_max=1.0, use_lrc=False)
    g = GCMC(lj_system(1, eps=0.0), params, activity=ladder, capacity=96)
    st = g.init(jax.random.PRNGKey(5), box=box, n_init=10,
                n_chains=ladder.size)
    st, _ = g.run_block(st, 3000)
    n_sum = np.zeros(ladder.size)
    blocks = 8
    for _ in range(blocks):
        st, stats = g.run_block(st, 800, drift_tol=1e-10)
        assert stats["full_frac"] == 0.0
        n_sum += np.asarray(jnp.sum(st.active, axis=1))
    per_chain = n_sum / blocks
    rung_means = per_chain.reshape(len(zs), per).mean(axis=1)
    np.testing.assert_allclose(rung_means, zs * box**3, rtol=0.05)
    # rungs must DIFFER (the ladder actually reached the kernel)
    assert rung_means[-1] > 4 * rung_means[0]


def test_gcmc_activity_ladder_length_mismatch_raises():
    params = RunParams(strict_min_image=False, temperature=1.5, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.3,
                       dr_max=1.0, use_lrc=False)
    g = GCMC(lj_system(1, eps=0.0), params, activity=np.asarray([0.1, 0.2]),
             capacity=16)
    with pytest.raises(ValueError, match="ladder"):
        g.init(jax.random.PRNGKey(0), box=6.0, n_init=4, n_chains=8)


def test_cli_gcmc_lrc_end_to_end(tmp_path):
    """Round-5 regression: `use_lrc: true` through the CLI config layer
    on an open ensemble.  Every fluctuating-N app REFUSED tail
    corrections before round 5 (`use_lrc=False` enforced at init), so a
    JSON config with the flag used to raise here; now the tail enters
    every exchange acceptance (ops/tail.mol_tail_coeff — exactness gates
    in tests/test_lrc_exchange.py).  This checks the config->app wiring:
    the run completes, bookkeeping stays drift-consistent with the tail
    folded into carried energies, and the attractive tail raises <N>
    vs the uncorrected run at the same activity."""
    import json

    from metropolismontecarlo_tpu.run import main

    def run(use_lrc, out):
        cfg = {
            "model": {"kind": "lj", "n_mol": 1},
            "params": {"temperature": 1.5, "r_cut": 2.5,
                       "cutoff_mode": "site", "coulomb": "none",
                       "p_translate": 0.6, "dr_max": 0.3,
                       "use_lrc": use_lrc, "strict_min_image": False},
            "run": {"n_chains": 32, "n_blocks": 4, "n_steps": 400,
                    "equil_blocks": 2, "seed": 3, "dtype": "float64",
                    "ensemble": {"kind": "gcmc", "activity": 0.08,
                                 "capacity": 64, "box": 6.0,
                                 "n_init": 20},
                    "output": {"dir": str(tmp_path / out)}},
        }
        p = tmp_path / f"{out}.json"
        p.write_text(json.dumps(cfg))
        main([str(p), "--quiet"])
        lines = [json.loads(l) for l in
                 (tmp_path / out / "metrics.jsonl").read_text()
                 .splitlines()]
        assert all(np.isfinite(l["energy_mean"]) for l in lines)
        assert all(l["drift_max_rel"] < 1e-6 for l in lines)
        prod = [l for l in lines if l.get("phase") == "prod"]
        return np.mean([l["n_mean"] for l in prod])

    n_on = run(True, "lrc_on")
    n_off = run(False, "lrc_off")
    # z = 0.08 in a 216 sigma^3 box sits well into the interacting
    # regime; the attractive tail deepens the effective field, so the
    # corrected run must hold measurably more particles (the exact
    # reweighting identity is gated in test_lrc_exchange.py — this is
    # only a wiring-direction check, hence the loose margin)
    assert n_on > n_off + 0.5, (n_on, n_off)
