"""Throughput probe: MC sweeps/sec aggregated over parallel chains, on one
GPU, against the reference's ~2.8 sweeps/s serial-Julia figure
(`Ewald/readme.md:28`; BASELINE.md).

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "platform": "gpu", "device_kind": "...", ...}

Variants via BENCH_CONFIG: spce (default; configs/spce_750.json) | wolf
(configs/spce_wolf.json) | lj | triatomic (configs/triatomic_cnf.json) |
npt | mixture (ragged 1900 SPC/E + 100 CO2), plus the open ensembles
gcmc and tmmc (molecular muVT water), gibbs (two-box molecular Gibbs
water) and semigrand (two-species water).  For the open ensembles one
timed unit is one sweep-equivalent of attempts (cap displacement/
rotation/exchange attempts; 2*cap for Gibbs), so the number compares to
the NVT sweeps/s.  Starts are the shipped configurations' seeded
lattices.  BENCH_CHAINS and BENCH_STEPS control scale; "first_call_s" is
the wall of the warm-up call (compile + first execution).  Exits
non-zero, printing no result, when JAX finds no GPU.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from metropolismontecarlo_tpu.io.configs import cubic_lattice  # noqa: E402
from metropolismontecarlo_tpu.mc.driver import MonteCarlo  # noqa: E402
from metropolismontecarlo_tpu.models.system import RunParams  # noqa: E402

BASELINE_SWEEPS_PER_SEC = 2.8  # serial Julia, 1 CPU core
CONFIG_FILES = {"spce": "spce_750.json", "wolf": "spce_wolf.json",
                "npt": "spce_750.json", "triatomic": "triatomic_cnf.json"}


def _from_config(name, n_chains, **param_overrides):
    """MonteCarlo + seeded start of a shipped configuration."""
    import dataclasses

    from metropolismontecarlo_tpu.run import _initial_state
    from metropolismontecarlo_tpu.utils.config import (
        build_params,
        build_system,
        load_config,
    )

    path = os.path.join(REPO, "configs", name)
    cfg = load_config(path)
    system = build_system(cfg, os.path.dirname(path))
    params = dataclasses.replace(build_params(cfg), **param_overrides)
    run_cfg = dict(cfg["run"], n_chains=n_chains)
    mc = MonteCarlo(system, params, dtype=jnp.float32)
    state = _initial_state(mc, run_cfg, system, os.path.dirname(path))
    return mc, state


def _setup(config, n_chains):
    key = jax.random.PRNGKey(0)
    if config in ("spce", "wolf"):
        mc, state = _from_config(CONFIG_FILES[config], n_chains)
        label = f"SPC/E 750-water {mc.params.coulomb.capitalize()} NVT"
    elif config == "lj":
        from metropolismontecarlo_tpu.models.monatomic import (
            lj_box_for_density, lj_system)
        n = 256
        box = lj_box_for_density(n, 0.75)
        params = RunParams(temperature=1.0, r_cut=2.5, cutoff_mode="site",
                           coulomb="none", p_translate=1.0, dr_max=box / 30)
        mc = MonteCarlo(lj_system(n), params, dtype=jnp.float32)
        state = mc.init_state(key, cubic_lattice(n, box), box=box,
                              n_chains=n_chains)
        label = "256-atom LJ fluid NVT"
    elif config == "triatomic":
        mc, state = _from_config(CONFIG_FILES[config], n_chains)
        label = "256-triatomic Mossa LJ NVT"
    elif config == "npt":
        # SPC/E NPT with volume-change moves + full recompute (the
        # reference's volumeChange.jl path), 1 bar
        p_bar = 1.0e5 / 1.380649e-23 * 1e-30      # 1 bar in K/A^3
        mc, state = _from_config(CONFIG_FILES[config], n_chains,
                                 pressure=p_bar, p_volume=0.05,
                                 dv_max=0.01)
        label = "SPC/E 750-water Ewald NPT (1 bar)"
    elif config == "mixture":
        from metropolismontecarlo_tpu.models.linear import co2_system
        from metropolismontecarlo_tpu.models.mixture import mixture_system
        from metropolismontecarlo_tpu.models.water import spce_system
        system = mixture_system([(co2_system(1), 100),
                                 (spce_system(1), 1900)], name="co2+spce")
        params = RunParams(temperature=298.15, r_cut=10.0, cutoff_mode="site",
                           coulomb="ewald", p_translate=0.5, dr_max=0.25,
                           dphi_max=0.25)
        box = (system.n_mol / 0.004) ** (1.0 / 3.0)
        mc = MonteCarlo(system, params, dtype=jnp.float32)
        state = mc.init_state(key, cubic_lattice(system.n_mol, box),
                              box=box, n_chains=n_chains)
        label = "CO2+SPC/E 2000-molecule ragged Ewald NVT"
    else:
        raise SystemExit(f"unknown BENCH_CONFIG {config!r}")
    return mc, state, label


def setup_muvt(config, n_chains):
    """Molecular muVT water (gcmc) or its TMMC flat-histogram variant
    (tmmc): cap-128 SPC/E, z = 2.2e-4, p_exchange = 0.3.  Returns
    (run(state, n_units), state, label, attempts per unit, ensemble)."""
    from metropolismontecarlo_tpu.mc.gcmc_mol import MolGCMC
    from metropolismontecarlo_tpu.mc.tmmc import TMMCMol
    from metropolismontecarlo_tpu.models.water import spce_system

    cap, box, px = 128, 16.0, 0.3
    params = RunParams(temperature=500.0, r_cut=6.0, cutoff_mode="site",
                       coulomb="ewald", nk=5, ksq_max=27, p_translate=0.5,
                       dr_max=0.4, dphi_max=0.4, use_lrc=False,
                       strict_min_image=False)
    cls = TMMCMol if config == "tmmc" else MolGCMC
    ens = cls(spce_system(cap), params, activity=2.2e-4, p_exchange=px,
              dtype=jnp.float32)
    state = ens.init(jax.random.PRNGKey(0), box=box, n_init=cap // 2,
                     n_chains=n_chains)
    label = (f"SPC/E muVT{' TMMC' if config == 'tmmc' else ''} cap-{cap}, "
             f"z=2.2e-4, p_exchange={px}")
    if config == "tmmc":
        eta = jnp.zeros(cap + 1, jnp.float32)

        def run(state, n_units):
            return ens._run_steps(state, eta, n_units * cap)[0]
    else:
        def run(state, n_units):
            return ens.run_steps(state, n_units * cap)
    return run, state, label, cap, ens


def setup_gibbs(n_chains):
    """Two-box molecular Gibbs water, cap 128 per box; one unit = 2*cap
    attempts."""
    from metropolismontecarlo_tpu.mc.gibbs_mol import MolGibbsEnsemble
    from metropolismontecarlo_tpu.models.water import spce_system
    from metropolismontecarlo_tpu.ops.ewald import tune_parameters

    cap, px = 128, 0.3
    n_l, n_v = (2 * cap) // 3, cap // 6
    box_l = (n_l / 0.0267) ** (1.0 / 3.0)     # ~0.80 g/cc
    box_v = 18.0                              # dense vapor: K stays modest
    r_cut = min(7.5, 0.45 * box_l)
    # tune at the largest volume-exchange-reachable box, (V_l+V_v)^(1/3)
    box_max = (box_l**3 + box_v**3) ** (1.0 / 3.0)
    kl, nk, ksq = tune_parameters(box_max, r_cut, 1e-3)
    params = RunParams(temperature=450.0, r_cut=r_cut, cutoff_mode="site",
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       p_translate=0.5, dr_max=0.3, dphi_max=0.4,
                       p_volume=0.002, use_lrc=False,
                       strict_min_image=False)
    ens = MolGibbsEnsemble(spce_system(cap), params, dv_max=0.03,
                           p_transfer=px, dtype=jnp.float32)
    state = ens.init(jax.random.PRNGKey(0), boxes=(box_l, box_v),
                     n_init=(n_l, n_v), n_chains=n_chains)
    label = f"SPC/E Gibbs cap-{cap}x2, p_transfer={px}"

    def run(state, n_units):
        return ens.run_steps(state, n_units * 2 * cap)

    return run, state, label, 2 * cap, ens


def setup_semigrand(n_chains):
    """Two-species semigrand water (identical SPC/E blocks, fugacity
    ratio 2), M = 128 slots; one unit = M attempts."""
    from metropolismontecarlo_tpu.mc.semigrand import Semigrand
    from metropolismontecarlo_tpu.models.system import System
    from metropolismontecarlo_tpu.models.water import spce_system

    cap, px = 64, 0.3
    w = spce_system(2 * cap)
    system = System(n_mol=2 * cap, atoms_per_mol=3, body=w.body,
                    masses=w.masses, charges=w.charges,
                    type_ids=w.type_ids, eps_table=w.eps_table,
                    sig_table=w.sig_table, name="sg-spce",
                    species=(("wA", cap, 3), ("wB", cap, 3)))
    params = RunParams(temperature=600.0, r_cut=8.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=1.0, dphi_max=0.7, strict_min_image=False)
    ens = Semigrand(system, params, fugacity_ratio=2.0, p_flip=px,
                    dtype=jnp.float32)
    state = ens.init(jax.random.PRNGKey(0), box=20.0, n_a=32, n_b=32,
                     n_chains=n_chains)
    M = 2 * cap
    label = f"SPC/E semigrand cap-{cap}+{cap}, xi=2, p_flip={px}"

    def run(state, n_units):
        return ens.run_steps(state, n_units * M)

    return run, state, label, M, ens


def main():
    from metropolismontecarlo_tpu.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        raise SystemExit(2)
    enable_compile_cache()
    config = os.environ.get("BENCH_CONFIG", "spce")
    default_chains = {"mixture": 256, "gcmc": 1024, "tmmc": 1024,
                      "gibbs": 1024, "semigrand": 1024}.get(config, 2048)
    n_chains = int(os.environ.get("BENCH_CHAINS", str(default_chains)))
    # npt: the timed window must cover one full volume-attempt period
    # (round(1/p_volume) = 20 sweeps) or the O(A^2) volume recompute is
    # never paid; lj: time a 50-sweep window so per-call launch overhead
    # does not dominate
    default_steps = {"npt": 20, "lj": 50, "triatomic": 20, "gcmc": 16,
                     "tmmc": 16, "gibbs": 16,
                     "semigrand": 16}.get(config, 2)
    n_steps = int(os.environ.get("BENCH_STEPS", str(default_steps)))

    if config == "gibbs":
        run, state, label, _, _ = setup_gibbs(n_chains)
    elif config == "semigrand":
        run, state, label, _, _ = setup_semigrand(n_chains)
    elif config in ("gcmc", "tmmc"):
        run, state, label, _, _ = setup_muvt(config, n_chains)
    else:
        mc, state, label = _setup(config, n_chains)

        def run(state, n_steps):
            return mc.run_steps(state, n_steps, False)

    t_c0 = time.perf_counter()
    warm = run(state, n_steps)
    jax.block_until_ready(warm.energy)
    first_call_s = time.perf_counter() - t_c0

    t0 = time.perf_counter()
    state = run(state, n_steps)
    jax.block_until_ready(state.energy)
    dt = time.perf_counter() - t0

    sweeps_per_sec = n_chains * n_steps / dt
    print(json.dumps({
        "metric": f"MC sweeps/sec ({label}, {n_chains} chains, f32)",
        "value": sweeps_per_sec,
        "unit": "sweeps/s",
        "vs_baseline": sweeps_per_sec / BASELINE_SWEEPS_PER_SEC,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "config": config,
        "chains": n_chains,
        "steps": n_steps,
        "dtype": "float32",
        "first_call_s": first_call_s,
        "command": (f"BENCH_CONFIG={config} BENCH_CHAINS={n_chains} "
                    f"BENCH_STEPS={n_steps} python bench.py"),
    }))


if __name__ == "__main__":
    main()
