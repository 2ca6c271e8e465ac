"""MBAR temperature reweighting of a real REMC run.

One replica-exchange run should yield thermodynamics as CONTINUOUS
functions of temperature, not just at the ladder rungs — that is the
point of mc/mbar.reweight_temperature.  This runs a 64-replica LJ
ladder (sweeps, exchanges every round,
slot temperatures fixed so slot k samples the T_k equilibrium), logs
the per-slot energies each round, and gates the MBAR post-processing
three ways:

  (1) self-consistency — reweighting AT each rung must reproduce that
      rung's direct time average (the weights degenerate correctly),
  (2) thermodynamic identity — the MBAR fluctuation heat capacity
      Var(E)/T^2 at the midpoints between rungs must match the
      finite-difference slope d<E>/dT of the direct rung averages,
  (3) honesty — between-rung targets keep a large Kish effective
      sample size while a far-extrapolation target's ESS collapses.

Reference anchor: the reference has neither REMC (its own TODO,
`Ewald/main.jl:55`) nor any reweighting machinery (SURVEY §2).

Run: `python docs/validation/run_remc_mbar.py`.
Writes docs/validation/remc_mbar.txt.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import jax

from metropolismontecarlo_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import numpy as np

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.mc.mbar import reweight_temperature
from metropolismontecarlo_tpu.models.monatomic import (lj_box_for_density,
                                                       lj_system)
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.parallel.remc import exchange, temperature_ladder

N, RHO = 256, 0.75
C = 64                      # replicas / ladder rungs
T_LO, T_HI = 0.9, 2.0
EQUIL, ROUNDS, SWEEPS = 400, 400, 5


def main():
    dev = jax.devices()[0]
    box = lj_box_for_density(N, RHO)
    params = RunParams(temperature=1.0, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=box / 30)
    ladder = np.asarray(temperature_ladder(T_LO, T_HI, C), np.float64)
    t0 = time.time()

    mc = MonteCarlo(lj_system(N), params)
    state = mc.init_state(jax.random.PRNGKey(0), cubic_lattice(N, box),
                          box=box, n_chains=C)
    state = state._replace(temp=jax.numpy.asarray(ladder, state.temp.dtype))
    state = mc.run_steps(state, EQUIL, False)
    key = jax.random.PRNGKey(99)
    e_rounds = np.empty((ROUNDS, C))
    swaps = []
    for r in range(ROUNDS):
        state = mc.run_steps(state, SWEEPS, False)
        state, frac = exchange(state, jax.random.fold_in(key, r), r % 2)
        swaps.append(float(frac))
        e_rounds[r] = np.asarray(state.energy)
    swap_frac = float(np.mean(swaps))
    e_kn = e_rounds.T                      # (K=C rungs, S=ROUNDS samples)
    direct = e_kn.mean(axis=1)
    # crude per-rung SEM treating rounds as ~independent units
    sem = e_kn.std(axis=1) / np.sqrt(ROUNDS)

    # (1) reweight AT the rungs
    at = reweight_temperature(e_kn, ladder, ladder)
    z = (at["e_mean"] - direct) / np.maximum(sem, 1e-9)
    rms_z = float(np.sqrt(np.mean(z ** 2)))

    # (2) C_v identity: MBAR Var(E)/T^2 AT the interior rungs vs the
    # centered finite-difference slope of the DIRECT rung means.  The
    # stride must be wide: adjacent rungs are ~1.3% apart in T, so a
    # 1-rung FD amplifies the rung SEM by ~1/dT into ~25% slope noise;
    # a 4-rung half-width keeps the noise ~ a few % while C_v is smooth
    # over the ~10% T span.
    w = 4
    interior = np.arange(w, C - w)
    fd = (direct[interior + w] - direct[interior - w]) / (
        ladder[interior + w] - ladder[interior - w])
    rel = np.abs(at["c"][interior] - fd) / np.abs(fd)
    med_rel = float(np.median(rel))
    mids = 0.5 * (ladder[:-1] + ladder[1:])
    mid = reweight_temperature(e_kn, ladder, mids)

    # (3) ESS honesty
    ess_mid_min = float(np.min(mid["ess"]))
    far = reweight_temperature(e_kn, ladder, [5.0 * T_HI])
    ess_far = float(far["ess"][0])

    n_pool = e_kn.size
    ok = (rms_z < 3.0 and med_rel < 0.15
          and ess_mid_min > 0.05 * n_pool and ess_far < 0.01 * n_pool
          and 0.0 < swap_frac < 1.0)
    lines = [
        "MBAR temperature reweighting of a REMC run (LJ fluid)",
        f"device: {dev.device_kind}, backend: {jax.default_backend()}",
        f"protocol: N={N} rho={RHO}, {C} rungs T in [{T_LO}, {T_HI}], "
        f"{EQUIL} equil + {ROUNDS}x{SWEEPS} sweeps, exchange every round, "
        f"jnp path f32; pooled samples {n_pool}",
        f"swap fraction: {swap_frac:.3f} (must discriminate: in (0,1))",
        f"(1) rung self-consistency: rms z-score {rms_z:.2f} (bound 3.0)",
        f"(2) C_v identity: median |Cv_mbar - d<E>/dT| / |d<E>/dT| "
        f"= {med_rel:.3f} over {interior.size} interior rungs "
        f"(centered FD half-width {w} rungs; bound 0.15)",
        f"(3) ESS: min between-rung {ess_mid_min:.0f} "
        f"(> {0.05 * n_pool:.0f}); far extrapolation T={5.0 * T_HI:.1f} "
        f"-> {ess_far:.1f} (< {0.01 * n_pool:.0f})",
        f"example curve: <E>/N at T=1.23 (never sampled) = "
        f"{reweight_temperature(e_kn, ladder, [1.23])['e_mean'][0] / N:.4f}",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "remc_mbar.txt")
    with open(path, "w") as f:
        f.write(out)
    print("wrote", path)


if __name__ == "__main__":
    main()
