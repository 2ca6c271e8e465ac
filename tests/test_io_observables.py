"""Checkpoint/resume determinism, RDF sanity, PDB round-trip, JSON config,
and the CLI runner end-to-end."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.io.checkpoint import load_state, save_state
from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.io.pdb import read_pdb, write_pdb
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.monatomic import lj_box_for_density, lj_system
from metropolismontecarlo_tpu.models.system import RunParams, SimState
from metropolismontecarlo_tpu.models.water import spce_system
from metropolismontecarlo_tpu.observables import RDFAccumulator


def _water_mc():
    system = spce_system(8)
    params = RunParams(temperature=300.0, r_cut=5.0, cutoff_mode="site",
                       coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
                       dr_max=0.3, dphi_max=0.4)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=4)
    state = mc.init_state(jax.random.PRNGKey(0), cubic_lattice(8, 12.0),
                          box=12.0, n_chains=4)
    return mc, state


def test_checkpoint_resume_exact_trajectory(tmp_path):
    """A resumed run must continue the EXACT stochastic trajectory: run
    10+10 sweeps vs save@10 / load / 10 sweeps — identical states."""
    mc, state = _water_mc()
    mid = mc.run_steps(state, 10, False)
    ref = mc.run_steps(mid, 10, False)

    path = tmp_path / "ck.npz"
    save_state(path, mid, metadata={"block": 1})
    loaded_np, meta = load_state(path)
    assert int(meta["block"]) == 1
    loaded = SimState(*[jnp.asarray(x) for x in loaded_np])
    out = mc.run_steps(loaded, 10, False)
    for f in SimState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(out, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_rdf_ideal_gas_is_flat():
    """Non-interacting particles must give g(r) ~ 1 everywhere."""
    n = 64
    system = lj_system(n, eps=0.0)
    params = RunParams(temperature=1.0, r_cut=2.0, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=2.0,
                       use_lrc=False)
    box = lj_box_for_density(n, 0.5)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=8)
    state = mc.init_state(jax.random.PRNGKey(1), cubic_lattice(n, box),
                          box=box, n_chains=16)
    state = mc.run_steps(state, 30, False)  # randomize
    rdf = RDFAccumulator(system, 0, 0, r_max=box / 2, n_bins=24)
    for _ in range(5):
        state = mc.run_steps(state, 5, False)
        rdf.update(state)
    r, g = rdf.result()
    # skip the first bins (few counts); the rest must be ~1
    assert np.all(np.abs(g[4:] - 1.0) < 0.15), g


def test_rdf_excluded_core_for_lj():
    """Interacting LJ fluid: g(r)=0 inside the core, peak near r=1."""
    n, rho, t = 64, 0.7, 1.2
    box = lj_box_for_density(n, rho)
    system = lj_system(n)
    params = RunParams(strict_min_image=False, temperature=t, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=0.25,
                       use_lrc=False)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=8)
    state = mc.init_state(jax.random.PRNGKey(2), cubic_lattice(n, box),
                          box=box, n_chains=16)
    state = mc.run_steps(state, 60, False)
    rdf = RDFAccumulator(system, 0, 0, r_max=box / 2, n_bins=40)
    for _ in range(5):
        state = mc.run_steps(state, 10, False)
        rdf.update(state)
    r, g = rdf.result()
    assert np.all(g[r < 0.85] < 0.05)
    assert g[(r > 1.0) & (r < 1.35)].max() > 1.5


def test_pdb_roundtrip(tmp_path):
    coords = np.random.default_rng(0).uniform(0, 10, (6, 3))
    path = tmp_path / "t.pdb"
    write_pdb(path, coords, ["OW", "HW", "HW"] * 2, ["WAT"] * 6,
              np.repeat([1, 2], 3), box=10.0)
    data = read_pdb(path)
    np.testing.assert_allclose(data["coords"], coords, atol=2e-3)
    assert data["box"][0] == pytest.approx(10.0)


def test_cli_end_to_end(tmp_path):
    """Full CLI run from a JSON config: metrics, RDF, checkpoint, resume."""
    cfg = {
        "model": {"kind": "lj", "n_mol": 27},
        "params": {"strict_min_image": False, "temperature": 1.5, "r_cut": 2.5, "cutoff_mode": "site",
                   "coulomb": "none", "p_translate": 1.0, "dr_max": 0.3,
                   "use_lrc": True},
        "run": {"n_chains": 8, "n_blocks": 3, "n_steps": 10,
                "equil_blocks": 1, "seed": 1, "dtype": "float32",
                "start": {"kind": "lattice", "density": 0.6},
                "output": {"dir": str(tmp_path / "out"),
                           "checkpoint_every": 1, "pdb_every": 2,
                           "rdf": {"type_i": 0, "type_j": 0, "r_max": 1.5,
                                   "n_bins": 20}}},
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))

    from metropolismontecarlo_tpu.run import main
    out_dir = tmp_path / "out"
    main([str(cfg_path), "--quiet"])
    assert (out_dir / "metrics.jsonl").exists()
    assert (out_dir / "rdf.txt").exists()
    assert (out_dir / "final.npz").exists()
    assert (out_dir / "checkpoint.npz").exists()
    assert (out_dir / "frame_2.pdb").exists()
    lines = [json.loads(l) for l in (out_dir / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 3
    assert all(np.isfinite(l["energy_mean"]) for l in lines)
    # resume from the checkpoint
    main([str(cfg_path), "--quiet", "--resume", str(out_dir / "checkpoint.npz")])


def test_cnf_roundtrip(tmp_path):
    from metropolismontecarlo_tpu.io.configs import read_cnf, write_cnf

    rng = np.random.default_rng(1)
    com = rng.uniform(-5, 5, (16, 3))
    quat = rng.normal(size=(16, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    path = tmp_path / "cfg.cnf"
    write_cnf(path, com, quat, 9.42953251)
    com2, quat2, box2 = read_cnf(path)
    np.testing.assert_allclose(com2, com, atol=1e-9)
    np.testing.assert_allclose(quat2, quat, atol=1e-9)
    assert box2 == pytest.approx(9.42953251)


def test_profiling_throughput_helper():
    from metropolismontecarlo_tpu.utils.profiling import sweeps_per_sec

    system = lj_system(27)
    params = RunParams(strict_min_image=False, temperature=1.5, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=0.3,
                       use_lrc=False)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=8)
    box = lj_box_for_density(27, 0.5)
    state = mc.init_state(jax.random.PRNGKey(11), cubic_lattice(27, box),
                          box=box, n_chains=8)
    rate = sweeps_per_sec(mc, state)
    assert rate > 0


def test_cli_annealing_schedule(tmp_path):
    """Annealing: equilibration blocks cool geometrically from t_start to
    the production temperature."""
    cfg = {
        "model": {"kind": "lj", "n_mol": 27},
        "params": {"strict_min_image": False, "temperature": 1.0, "r_cut": 2.5, "cutoff_mode": "site",
                   "coulomb": "none", "p_translate": 1.0, "dr_max": 0.3,
                   "use_lrc": False},
        "run": {"n_chains": 8, "n_blocks": 4, "n_steps": 5,
                "equil_blocks": 3, "seed": 2, "dtype": "float32",
                "anneal": {"t_start": 4.0},
                "start": {"kind": "lattice", "density": 0.5},
                "output": {"dir": str(tmp_path / "out")}}}
    import json as _json
    p = tmp_path / "cfg.json"
    p.write_text(_json.dumps(cfg))
    from metropolismontecarlo_tpu.run import main
    state = main([str(p), "--quiet"])
    # production temperature restored after annealing
    np.testing.assert_allclose(np.asarray(state.temp), 1.0, rtol=1e-6)


def test_dipole_accumulator_spce():
    """Per-molecule SPC/E dipole is analytic (2 q_H r_OH cos(theta/2) =
    0.4894 e.A, orientation-invariant); aligned molecules add, and the
    molecular (surface_dipole) form is invariant under periodic wrap."""
    from metropolismontecarlo_tpu.models.water import (
        SPCE_Q_H, SPCE_R_OH, SPCE_THETA)
    from metropolismontecarlo_tpu.observables import DipoleAccumulator
    from metropolismontecarlo_tpu.ops.quaternions import (
        random_quaternion, rotate_vectors)

    mu = 2.0 * SPCE_Q_H * SPCE_R_OH * np.cos(np.deg2rad(SPCE_THETA) / 2.0)
    box = 12.0

    # one molecule, random orientation: |M| = mu exactly
    sys1 = spce_system(1)
    p1 = RunParams(strict_min_image=False, temperature=300.0, r_cut=5.0,
                   coulomb="none", use_lrc=False)
    quat = random_quaternion(jax.random.PRNGKey(2), (1,), jnp.float64)
    com = jnp.asarray([[3.0, 4.0, 5.0]], jnp.float64)
    body = jnp.asarray(np.asarray(sys1.body), jnp.float64)
    coords = (com[:, None, :] + rotate_vectors(quat, body)).reshape(-1, 3)
    mc1 = MonteCarlo(sys1, p1, dtype=jnp.float64,
                     recompute_chunk=1)
    st1 = mc1.init_from_coords(jax.random.PRNGKey(0), coords, com, box=box,
                               n_chains=1)
    acc = DipoleAccumulator(sys1, chunk=1)
    acc.update(st1)
    res = acc.result()
    np.testing.assert_allclose(np.sqrt(res["m2_mean"]), mu, rtol=1e-10)
    np.testing.assert_allclose(res["g_kirkwood"], 1.0, rtol=1e-10)

    # two molecules, SAME orientation: M^2 = (2 mu)^2, g_K = 2
    sys2 = spce_system(2)
    com2 = jnp.asarray([[3.0, 3.0, 3.0], [9.0, 9.0, 9.0]], jnp.float64)
    quat2 = jnp.tile(quat, (2, 1))
    body2 = jnp.asarray(np.asarray(sys2.body), jnp.float64)
    coords2 = (com2[:, None, :]
               + rotate_vectors(quat2, body2)).reshape(-1, 3)
    mc2 = MonteCarlo(sys2, p1, dtype=jnp.float64,
                     recompute_chunk=1)
    st2 = mc2.init_from_coords(jax.random.PRNGKey(0), coords2, com2,
                               box=box, n_chains=1)
    acc2 = DipoleAccumulator(sys2, chunk=1)
    acc2.update(st2)
    res2 = acc2.result()
    np.testing.assert_allclose(np.sqrt(res2["m2_mean"]), 2.0 * mu,
                               rtol=1e-10)
    np.testing.assert_allclose(res2["g_kirkwood"], 2.0, rtol=1e-10)

    # wrap one molecule across the boundary: M unchanged
    coords2w = np.asarray(coords2).copy()
    coords2w[3:6] += box  # second molecule's atoms, one image over
    com2w = np.asarray(com2).copy()
    com2w[1] += box
    st2w = mc2.init_from_coords(jax.random.PRNGKey(0),
                                coords2w % box, com2w % box, box=box,
                                n_chains=1)
    acc2w = DipoleAccumulator(sys2, chunk=1)
    acc2w.update(st2w)
    np.testing.assert_allclose(acc2w.result()["m2_mean"],
                               res2["m2_mean"], rtol=1e-10)


def test_dielectric_constant_formula():
    """Hand-checked value: dm2 = 1 e^2 A^2 in V = 1000 A^3 at T = 300 K
    gives eps = 1 + (4 pi/3) * COULOMB_FACTOR / 3e5."""
    from metropolismontecarlo_tpu.observables import dielectric_constant
    from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR

    eps = dielectric_constant(1.0, np.zeros(3), 1000.0, 300.0)
    np.testing.assert_allclose(
        eps, 1.0 + 4.0 * np.pi / 3.0 * COULOMB_FACTOR / 3.0e5, rtol=1e-12)
    # mean subtraction: <M> = (1,0,0), <M^2> = 1 -> dm2 = 0 -> eps = 1
    eps0 = dielectric_constant(1.0, np.array([1.0, 0, 0]), 1000.0, 300.0)
    np.testing.assert_allclose(eps0, 1.0, atol=1e-12)


def test_energy_fluctuations_cv():
    """C_v,ex from pooled energy samples equals the NumPy population
    variance over T^2."""
    from metropolismontecarlo_tpu.observables import EnergyFluctuations

    rng = np.random.default_rng(0)
    temp = 250.0
    samples = rng.normal(-5.0e4, 300.0, size=(6, 4))  # 6 updates, 4 chains
    mc, state = _water_mc()
    acc = EnergyFluctuations()
    for s in samples:
        acc.update(state._replace(
            energy=jnp.asarray(s, jnp.float64),
            temp=jnp.full((4,), temp, jnp.float64)))
    res = acc.result()
    expect = np.var(samples) / temp**2
    # <E^2> - <E>^2 at E ~ -5e4 cancels ~9 digits: 1e-8 is f64-tight here
    np.testing.assert_allclose(res["cv_excess"], expect, rtol=1e-8)
    np.testing.assert_allclose(res["e_mean"], samples.mean(), rtol=1e-12)


def test_cli_fluctuation_observables(tmp_path):
    """CLI with dielectric/heat-capacity/Widom outputs enabled: a final
    observables record lands in metrics.jsonl with finite values."""
    cfg = {
        "model": {"kind": "spce", "n_mol": 8},
        "params": {"temperature": 300.0, "r_cut": 5.0, "coulomb": "ewald",
                   "nk": 3, "ksq_max": 9, "p_translate": 0.5,
                   "dr_max": 0.3, "dphi_max": 0.4},
        "run": {"n_chains": 4, "n_blocks": 3, "n_steps": 3,
                "equil_blocks": 1, "seed": 2, "dtype": "float64",
                "start": {"kind": "lattice", "box": 12.0},
                "output": {"dir": str(tmp_path / "out"),
                           "dielectric": True, "heat_capacity": True,
                           "widom": {"n_insertions": 8}}},
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    from metropolismontecarlo_tpu.run import main
    main([str(cfg_path), "--quiet"])
    lines = [json.loads(l) for l in
             (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    final = [l for l in lines if l.get("phase") == "final"]
    assert len(final) == 1
    f = final[0]
    for k in ("epsilon", "g_kirkwood", "cv_excess", "widom_boltzmann_mean",
              "mu_excess"):
        assert np.isfinite(f[k]), (k, f)
    assert f["epsilon"] >= 1.0 and f["g_kirkwood"] > 0.0
    assert f["cv_excess"] >= 0.0 and f["widom_boltzmann_mean"] >= 0.0
    prod = [l for l in lines if l.get("phase") == "prod"]
    assert all("widom_boltzmann_mean" in l and "epsilon_running" in l
               for l in prod)


def test_structure_factor_lattice_bragg_exact():
    """Perfect 4x4x4 cubic lattice: shell |n|^2 = 16 is ONLY (4,0,0)-type
    vectors (16 has a unique three-square decomposition), all of which
    are reciprocal-lattice vectors -> S = N exactly; shell |n|^2 = 1 has
    no reciprocal-lattice member -> S = 0 exactly.  Deterministic
    closed-form check of the phase matmuls and shell bookkeeping."""
    from metropolismontecarlo_tpu.observables import StructureFactorAccumulator

    n, box = 64, 8.0
    system = lj_system(n)
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.0,
                       cutoff_mode="site", coulomb="none", p_translate=1.0,
                       dr_max=0.1, use_lrc=False)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=2)
    state = mc.init_state(jax.random.PRNGKey(0), cubic_lattice(n, box),
                          box=box, n_chains=2)
    acc = StructureFactorAccumulator(system, n_max=4, chunk=2)
    acc.update(state)
    k, s = acc.result()
    shells = list(acc.shells)
    i16, i1 = shells.index(16), shells.index(1)
    assert s[i16] == pytest.approx(float(n), rel=1e-8), s[i16]
    assert abs(s[i1]) < 1e-8, s[i1]
    assert k[i1] == pytest.approx(2.0 * np.pi / box, rel=1e-12)


def test_structure_factor_ideal_gas_unity():
    """Uniform iid positions: <|rho_k|^2> = N for every commensurate
    k != 0, so S(k) = 1 in every shell (the S(k) analog of the flat-RDF
    test)."""
    from metropolismontecarlo_tpu.observables import StructureFactorAccumulator

    n, box, chains = 64, 10.0, 256
    system = lj_system(n)
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.0,
                       cutoff_mode="site", coulomb="none", p_translate=1.0,
                       dr_max=0.1, use_lrc=False)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=32)
    rng = np.random.default_rng(5)
    com = rng.uniform(0.0, box, size=(chains, n, 3))
    state = mc.init_state(jax.random.PRNGKey(1), com, box=box)
    acc = StructureFactorAccumulator(system, n_max=4, chunk=32)
    acc.update(state)
    _, s = acc.result()
    # per-shell SEM ~ 1/sqrt(multiplicity * chains) ~ 2-3%
    assert np.all(np.abs(s - 1.0) < 0.15), s


def test_cli_ewald_tol_tuning(tmp_path, capsys):
    """params.ewald_tol replaces the hardcoded kappa_L/nk/ksq_max with
    accuracy-targeted values at the start box (and the run still
    passes its drift gates)."""
    cfg = {
        "model": {"kind": "spce", "n_mol": 16},
        "params": {"strict_min_image": False, "temperature": 350.0,
                   "r_cut": 5.0, "cutoff_mode": "site",
                   "coulomb": "ewald", "ewald_tol": 1e-5},
        "run": {"n_chains": 2, "n_blocks": 2, "n_steps": 5,
                "equil_blocks": 1, "seed": 1, "dtype": "float64",
                "start": {"kind": "lattice", "box": 12.0},
                "output": {"dir": str(tmp_path / "out")}},
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    from metropolismontecarlo_tpu.ops.ewald import tune_parameters
    from metropolismontecarlo_tpu.run import main

    main([str(cfg_path)])
    out = capsys.readouterr().out
    kl, nk, ksq = tune_parameters(12.0, 5.0, 1e-5)
    assert f"nk = {nk}, ksq_max = {ksq}" in out
    assert nk != 5            # actually retuned away from the default
    lines = [json.loads(l) for l in
             (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert all(l["drift_max_rel"] < 1e-10 for l in lines)


def test_cli_pressure_ladder(tmp_path):
    """run.pressure_ladder: every chain equilibrates to its own isobar
    (monotone volumes across the ladder) in one CLI run."""
    cfg = {
        "model": {"kind": "lj", "n_mol": 16},
        "params": {"strict_min_image": False, "temperature": 2.0,
                   "r_cut": 1.0, "cutoff_mode": "site", "coulomb": "none",
                   "p_translate": 1.0, "dr_max": 1.0, "use_lrc": False,
                   "p_volume": 1.0, "dv_max": 0.3},
        "run": {"n_chains": 8, "n_blocks": 4, "n_steps": 120,
                "equil_blocks": 1, "seed": 3, "dtype": "float64",
                "pressure_ladder": {"p_min": 0.1, "p_max": 1.0},
                "start": {"kind": "lattice", "density": 0.3},
                "output": {"dir": str(tmp_path / "out")}},
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    from metropolismontecarlo_tpu.run import main

    state = main([str(cfg_path), "--quiet"])
    box = np.asarray(state.box)
    # 10x pressure span -> 10x volume span (ideal gas), i.e. a 2.15x
    # box span; the final state is ONE sample per chain (box sd ~ 8%),
    # so gate the endpoints with margin rather than strict monotonicity
    assert box[0] > 1.5 * box[-1], box
    assert box[:2].min() > box[-2:].max(), box


def test_blocking_analysis_ar1_closed_form():
    """Blocking analysis against an AR(1) process x_t = phi x_{t-1} +
    eps: the exact integrated autocorrelation time is
    tau = (1 + phi) / (2 (1 - phi)) and the true sem of the mean is
    sem_naive * sqrt(2 tau); the plateau estimate must recover both,
    and must reduce to the naive sem for white noise."""
    from metropolismontecarlo_tpu.observables import blocking_analysis

    rng = np.random.default_rng(3)
    phi, n = 0.9, 1 << 17
    eps = rng.normal(size=n)
    x = np.empty(n)
    x[0] = eps[0] / np.sqrt(1 - phi**2)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + eps[t]
    out = blocking_analysis(x)
    tau_exact = (1 + phi) / (2 * (1 - phi))          # 9.5
    assert out["tau"] == pytest.approx(tau_exact, rel=0.25), out
    assert out["sem"] == pytest.approx(
        out["sem_naive"] * np.sqrt(2 * tau_exact), rel=0.15), out

    w = rng.normal(size=1 << 14)
    out_w = blocking_analysis(w)
    # plateau-max reading is conservative: within ~20% above naive
    assert out_w["sem"] < 1.25 * out_w["sem_naive"], out_w
    assert out_w["tau"] < 0.8, out_w

    with pytest.raises(ValueError):
        blocking_analysis(np.ones(8))


def test_kirkwood_buff_exact_anchors():
    """G = 0 exactly for g == 1 (ideal gas) at every truncation; the
    hard step g = Theta(r - sigma) gives -4/3 pi sigma^3 (excluded
    volume) to quadrature accuracy."""
    from metropolismontecarlo_tpu.observables import kirkwood_buff_integral

    r = np.linspace(0.005, 8.0, 1600)
    assert kirkwood_buff_integral(r, np.ones_like(r)) == 0.0
    assert kirkwood_buff_integral(r, np.ones_like(r), r_upper=3.0) == 0.0
    sigma = 1.5
    g = (r >= sigma).astype(np.float64)
    exact = -4.0 / 3.0 * np.pi * sigma**3
    got = kirkwood_buff_integral(r, g)
    assert abs(got - exact) < 0.02 * abs(exact), (got, exact)


def test_heat_of_vaporization_ideal_zero():
    """Ideal gas: U = 0 and P v = kT in both boxes, so dH_vap == 0
    identically through the real Gibbs machinery (pressure_fd included)."""
    from metropolismontecarlo_tpu.mc.gibbs_mol import MolGibbsEnsemble
    from metropolismontecarlo_tpu.models.monatomic import lj_system
    from metropolismontecarlo_tpu.models.system import RunParams
    from metropolismontecarlo_tpu.observables import heat_of_vaporization

    params = RunParams(temperature=1.4, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=0.4,
                       use_lrc=False, p_volume=0.0,
                       strict_min_image=False)
    g = MolGibbsEnsemble(lj_system(24, eps=0.0), params,
                         p_transfer=0.4)
    st = g.init(jax.random.PRNGKey(0), boxes=(5.0, 7.0),
                n_init=(10, 6), n_chains=4)
    st, _ = g.run_block(st, 300)
    dh = heat_of_vaporization(st, g.pressure_fd(st))
    assert np.allclose(dh, 0.0, atol=1e-9), dh
