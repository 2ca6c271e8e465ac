"""TMMC gates (mc/tmmc.py) — closed forms and cross-implementation
checks, not regressions.

  * ideal gas: ln Pi(N) = N ln(zV) - ln N! exactly;
  * bias invariance: the collection matrix records UNBIASED acceptance
    probabilities, so any eta leaves ln Pi unchanged (only the sampled
    N range widens);
  * interacting LJ: P(N) from ln Pi must match a plain-GCMC histogram
    at the same state point (two different estimators, same model);
  * coexistence solver: synthetic double-Gaussian ln Pi with a known
    equal-weight activity;
  * the carried-energy drift invariant.
"""

import jax
import numpy as np
import pytest
from scipy.special import gammaln

from metropolismontecarlo_tpu.mc.tmmc import (
    TMMC,
    bias_from_lnpi,
    coexistence,
    lnpi_from_cmat,
    reweight_lnpi,
)
from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.system import RunParams


def _params(t=1.2, dr=0.4):
    return RunParams(strict_min_image=False, temperature=t, r_cut=2.5,
                     cutoff_mode="site", coulomb="none", p_translate=0.4,
                     dr_max=dr, use_lrc=False)


def _ideal_lnpi(zv, nmax):
    n = np.arange(nmax + 1)
    return n * np.log(zv) - gammaln(n + 1.0)


def test_ideal_gas_lnpi_exact():
    """eps = 0: every exchange acceptance probability is a CLOSED FORM
    (min(1, zV/(N+1)) up, min(1, N/zV) down) and the Rao-Blackwellized
    deposit is deterministic per N, so ln Pi is EXACT (to fp rounding)
    on the whole visited range after a single visit each."""
    box, z = 5.0, 0.08            # zV = 10
    t = TMMC(lj_system(1, eps=0.0), _params(), activity=z, capacity=48)
    st = t.init(jax.random.PRNGKey(0), box=box, n_init=10, n_chains=64)
    for _ in range(6):
        st, stats = t.run_block(st, 1500, drift_tol=1e-9)
    lnpi = t.lnpi()
    fin = np.isfinite(lnpi)
    exact = _ideal_lnpi(z * box**3, 48)
    i0 = np.where(fin)[0][0]
    d = (lnpi - lnpi[i0]) - (exact - exact[i0])
    assert np.sum(fin) > 15
    assert np.max(np.abs(d[fin])) < 1e-8, np.max(np.abs(d[fin]))


def test_bias_invariance_and_range_widening():
    """An arbitrary strong bias must leave ln Pi unchanged (C records
    unbiased probabilities) while widening the sampled N range."""
    box, z = 5.0, 0.08
    sys_ = lj_system(1, eps=0.0)

    t0 = TMMC(sys_, _params(), activity=z, capacity=48)
    st = t0.init(jax.random.PRNGKey(1), box=box, n_init=10, n_chains=64)
    for _ in range(4):
        st, s0 = t0.run_block(st, 1500, update_bias=False)   # eta = 0

    t1 = TMMC(sys_, _params(), activity=z, capacity=48)
    # strong arbitrary bias toward large N: eta(N) = +0.35 N
    t1.eta = 0.35 * np.arange(49, dtype=np.float64)
    st1 = t1.init(jax.random.PRNGKey(2), box=box, n_init=10, n_chains=64)
    for _ in range(4):
        st1, s1 = t1.run_block(st1, 1500, update_bias=False)

    l0, l1 = t0.lnpi(), t1.lnpi()
    both = np.isfinite(l0) & np.isfinite(l1)
    i0 = np.where(both)[0][0]
    d = (l0 - l0[i0]) - (l1 - l1[i0])
    # ideal gas + Rao-Blackwellized deposits: both runs are exact on
    # their visited ranges, so the biased and unbiased estimates must
    # coincide to fp rounding wherever both visited
    assert np.max(np.abs(d[both])) < 1e-8, np.max(np.abs(d[both]))
    # the biased walker pushed well past the unbiased Poisson peak
    assert s1["n_max"] > s0["n_max"] + 5


def test_interacting_matches_gcmc_histogram():
    """Same interacting model, two estimators: P(N) from the TMMC
    ln Pi vs a plain-GCMC N histogram."""
    from metropolismontecarlo_tpu.mc.gcmc import GCMC, n_counts

    box, z, temp = 5.0, 0.05, 1.5
    t = TMMC(lj_system(1), _params(temp), activity=z, capacity=64)
    st = t.init(jax.random.PRNGKey(3), box=box, n_init=12, n_chains=64)
    for _ in range(6):
        st, _ = t.run_block(st, 2000, drift_tol=1e-9, update_bias=False)
    lnpi = t.lnpi()

    g = GCMC(lj_system(1), _params(temp), activity=z, capacity=64)
    sg = g.init(jax.random.PRNGKey(4), box=box, n_init=12, n_chains=64)
    sg, _ = g.run_block(sg, 4000)
    hist = np.zeros(65, np.int64)
    for _ in range(6):
        sg, _ = g.run_block(sg, 1000, drift_tol=1e-9)
        hist += n_counts(sg, 64)

    fin = np.isfinite(lnpi)
    p_tm = np.where(fin, np.exp(lnpi - lnpi[fin].max()), 0.0)
    p_tm /= p_tm.sum()
    n = np.arange(65)
    mean_tm = float((n * p_tm).sum())
    mean_g = float((n * hist).sum() / hist.sum())
    # two independent stochastic estimates of <N>; generous bound
    assert abs(mean_tm - mean_g) < 0.05 * mean_g + 0.5, (mean_tm, mean_g)


def test_coexistence_solver_synthetic():
    """Double-Gaussian ln Pi built at known equal-weight activity z*:
    the solver must recover z* and the basin means."""
    n = np.arange(301, dtype=np.float64)
    m1, s1, m2, s2 = 20.0, 6.0, 220.0, 12.0
    v = 343.0
    # equal weights at z_star: both Gaussians integrate to ln w = 0
    lnpi_star = np.logaddexp(-0.5 * ((n - m1) / s1) ** 2 - np.log(s1),
                             -0.5 * ((n - m2) / s2) ** 2 - np.log(s2))
    z_star = 0.07
    z0 = 0.03          # de-tune: hand the solver the ln Pi at z0
    lnpi_z0 = lnpi_star + n * np.log(z0 / z_star)
    res = coexistence(lnpi_z0, z0, v)
    assert res["z_coex"] == pytest.approx(z_star, rel=1e-3)
    assert abs(res["dlnw"]) < 1e-6
    assert res["rho_vap"] == pytest.approx(m1 / v, rel=0.02)
    assert res["rho_liq"] == pytest.approx(m2 / v, rel=0.02)


def test_basin_split_prefers_deepest_valley():
    """A noise dimple near the dominant peak (>= n_sep away, ~1.2 kT
    deep) qualifies under the height-ordered rule and used to hijack
    the split; the prominence rule must pick the true far basin whose
    separating valley is many kT deep even when its peak is tilted far
    below the dimple."""
    n = np.arange(201, dtype=np.float64)
    main = -0.5 * ((n - 160.0) / 8.0) ** 2          # dominant (liquid)
    far = -12.0 - 0.5 * ((n - 20.0) / 6.0) ** 2     # true second basin
    lnpi = np.logaddexp(main, far)
    # carve a 1.3-kT dimple 14 states from the main peak: local min at
    # 146, local max at 140 — the dimple peak (~-2) towers over the far
    # peak (-12) but its valley is shallow
    lnpi[140:153] += 1.3 * np.cos(np.pi * (n[140:153] - 146) / 6.0) - 1.3
    from metropolismontecarlo_tpu.mc.tmmc import _basin_stats
    lw_v, lw_l, n_v, n_l = _basin_stats(lnpi, n_sep=10, min_barrier=1.0)
    assert n_v == pytest.approx(20.0, abs=2.0)
    assert n_l == pytest.approx(160.0, abs=2.0)


def test_surface_tension_known_barrier():
    """Piecewise ln Pi with peaks at 0 and a flat valley at -B: the
    Binder estimate must return exactly T*B/(2 L^2), robust to a 1-kT
    noise dimple riding on the valley."""
    from metropolismontecarlo_tpu.mc.tmmc import surface_tension
    n = np.arange(241, dtype=np.float64)
    B, box, temp = 14.0, 7.0, 0.9
    lnpi = np.full(241, -B)
    lnpi[:41] = -B * np.abs(n[:41] - 20.0) / 20.0          # vapor peak at 20
    lnpi[200:] = -B * np.abs(n[200:] - 220.0) / 20.0       # liquid peak at 220
    lnpi[100:113] += 0.9 * np.cos(np.pi * (n[100:113] - 106.0) / 6.0) + 0.9
    gamma = surface_tension(lnpi, box, temp)
    assert gamma == pytest.approx(temp * B / (2 * box**2), rel=1e-12)


def test_reweight_and_bias_utilities():
    lnpi = np.array([-np.inf, 0.0, 1.0, 0.5, -np.inf])
    out = reweight_lnpi(lnpi, 1.0, np.e)   # adds N per step
    fin = np.isfinite(out)
    assert fin.tolist() == [False, True, True, True, False]
    assert out[fin].max() == 0.0
    eta = bias_from_lnpi(lnpi)
    assert eta[0] == eta[1] == 0.0         # clamped + gauged at first
    assert eta[4] == eta[3]
    assert np.all(np.isfinite(eta))


def test_temperature_reweight_ideal_gas_exact():
    """Ideal gas: every configuration has U = 0, so the per-slice
    moments vanish and the temperature extension must return ln Pi
    unchanged (up to the common gauge max)."""
    from metropolismontecarlo_tpu.mc.tmmc import (TMMC,
                                                  reweight_lnpi_temperature)
    params = RunParams(strict_min_image=False, temperature=1.5, r_cut=2.5,
                       cutoff_mode="site", coulomb="none",
                       p_translate=0.3, dr_max=0.5, use_lrc=False)
    t = TMMC(lj_system(1, eps=0.0), params, activity=0.05, capacity=40)
    st = t.init(jax.random.PRNGKey(0), box=5.0, n_init=10, n_chains=32)
    st, _ = t.run_block(st, 1500, drift_tol=1e-10)
    lnpi = t.lnpi()
    out = reweight_lnpi_temperature(lnpi, t.uhist, 1.5, 1.2)
    fin = np.isfinite(lnpi)
    d = (out[fin] - out[fin][0]) - (lnpi[fin] - lnpi[fin][0])
    assert np.max(np.abs(d)) < 1e-12, np.max(np.abs(d))


def test_temperature_reweight_matches_direct_run():
    """Interacting LJ: ln Pi extrapolated from T = 1.30 to T = 1.40 via
    the per-slice energy moments must match a DIRECT T = 1.40 run on
    the shared visited range (supercritical, single-basin — shape
    comparison after a least-squares gauge shift)."""
    from metropolismontecarlo_tpu.mc.tmmc import (TMMC,
                                                  reweight_lnpi_temperature)

    def sample(temp, seed):
        params = RunParams(strict_min_image=False, temperature=temp,
                           r_cut=2.5, cutoff_mode="site", coulomb="none",
                           p_translate=0.4, dr_max=0.4, use_lrc=False)
        t = TMMC(lj_system(1), params, activity=0.08, capacity=48)
        st = t.init(jax.random.PRNGKey(seed), box=4.5,
                    n_init=np.linspace(2, 40, 64).astype(np.int32),
                    n_chains=64)
        for b in range(8):
            st, _ = t.run_block(st, 1200, drift_tol=1e-9)
            if b == 1:
                t.reset_collection()
        return t

    t_lo = sample(1.30, 11)
    t_hi = sample(1.40, 12)
    lnpi_ex = reweight_lnpi_temperature(t_lo.lnpi(), t_lo.uhist,
                                        1.30, 1.40)
    lnpi_dir = t_hi.lnpi()
    both = np.isfinite(lnpi_ex) & np.isfinite(lnpi_dir)
    assert both.sum() >= 25
    d = lnpi_ex[both] - lnpi_dir[both]
    d -= d.mean()                      # gauge
    # bound calibrated against pure sampling noise: two DIRECT runs at
    # the same T and this protocol differ by max|d| ~ 0.28 (edge noise
    # accumulates as a random walk along N); extrapolation-vs-direct
    # combines two such independent walks plus O(db^3) truncation
    span = lnpi_dir[both].max() - lnpi_dir[both].min()
    assert span > 5.0
    assert np.max(np.abs(d)) < 0.6, (np.max(np.abs(d)), span)


def test_cli_tmmc_end_to_end(tmp_path):
    """CLI `"ensemble": {"kind": "tmmc"}`: stratified starts, burn-in
    discard, lnpi.txt written, finite ln Pi over a contiguous range."""
    import json

    cfg = {
        "model": {"kind": "lj", "n_mol": 1},
        "params": {"strict_min_image": False, "temperature": 1.5,
                   "r_cut": 2.5, "cutoff_mode": "site", "coulomb": "none",
                   "p_translate": 0.3, "dr_max": 0.5, "use_lrc": False},
        "run": {"n_chains": 16, "n_blocks": 4, "n_steps": 400, "seed": 2,
                "dtype": "float64",
                "ensemble": {"kind": "tmmc", "activity": 0.05,
                             "capacity": 40, "box": 5.0,
                             "n_init": [1, 30], "discard_blocks": 1},
                "output": {"dir": str(tmp_path / "out")}},
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    from metropolismontecarlo_tpu.run import main
    main([str(cfg_path), "--quiet"])
    lines = (tmp_path / "out" / "lnpi.txt").read_text().splitlines()
    data = np.array([l.split() for l in lines[1:]], dtype=np.float64)
    assert data.shape[0] >= 10
    assert np.all(np.isfinite(data[:, 1]))
    assert np.all(np.diff(data[:, 0]) == 1)      # contiguous N range
    metrics = [json.loads(l) for l in
               (tmp_path / "out" / "metrics.jsonl").read_text()
               .splitlines()]
    phases = [m["phase"] for m in metrics]
    assert phases.count("burnin") == 1 and phases.count("prod") == 3


def test_empty_cmat_raises():
    with pytest.raises(ValueError, match="no measured transitions"):
        lnpi_from_cmat(np.zeros((10, 3)))
