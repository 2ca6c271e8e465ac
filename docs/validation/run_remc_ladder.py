"""REMC sampling validation: ladder averages vs independent NVT.

Parallel tempering must not change single-temperature equilibrium
averages — it only accelerates mixing.  This runs the SAME 64-replica
LJ temperature ladder twice (sweeps):

  (a) REMC: exchange round (alternating even/odd phases) every sweep,
  (b) control: identical chains, never exchanged,

and compares the per-temperature mean energies.  Agreement within
combined statistical error validates the exchange rule (detailed
balance of the swap acceptance), the configuration/structure-factor
swap plumbing, and the per-temperature step-size bookkeeping at once.
Reference anchor: REMC is the reference's own unimplemented TODO
(`Ewald/main.jl:55`).

Run: `python docs/validation/run_remc_ladder.py`.
Writes docs/validation/remc_ladder.txt.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import jax

from metropolismontecarlo_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.monatomic import (lj_box_for_density,
                                                       lj_system)
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.parallel.remc import exchange, temperature_ladder

N, RHO = 256, 0.75
C = 64                      # replicas
T_LO, T_HI = 0.9, 2.0
EQUIL, ROUNDS, SWEEPS = 400, 300, 5


def run(mc, state, do_exchange, key):
    state = mc.run_steps(state, EQUIL, False)
    e_sum = np.zeros(C)
    swaps = []
    for r in range(ROUNDS):
        state = mc.run_steps(state, SWEEPS, False)
        if do_exchange:
            state, frac = exchange(state, jax.random.fold_in(key, r), r % 2)
            swaps.append(float(frac))
        e_sum += np.asarray(state.energy)
    return e_sum / ROUNDS, (float(np.mean(swaps)) if swaps else 0.0), state


def main():
    dev = jax.devices()[0]
    box = lj_box_for_density(N, RHO)
    params = RunParams(temperature=1.0, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=box / 30)
    ladder = temperature_ladder(T_LO, T_HI, C)
    t0 = time.time()
    results = {}
    for label, do_x, seed in (("remc", True, 0), ("control", False, 1)):
        mc = MonteCarlo(lj_system(N), params)
        state = mc.init_state(jax.random.PRNGKey(seed),
                              cubic_lattice(N, box), box=box, n_chains=C)
        state = state._replace(temp=ladder.astype(state.temp.dtype))
        e_mean, swap, _ = run(mc, state, do_x, jax.random.PRNGKey(99))
        results[label] = (e_mean, swap)

    e_r, swap_frac = results["remc"]
    e_c, _ = results["control"]
    # per-temperature comparison in reduced units per particle
    d = (e_r - e_c) / N
    # scale of per-T statistical error: LJ energy fluctuations ~ sqrt(C_v)
    # per sample; with ROUNDS correlated samples be generous
    rms = float(np.sqrt(np.mean(d ** 2)))
    worst = float(np.max(np.abs(d)))
    mono = float(np.mean(np.sign(np.diff(e_r))))  # E must rise with T
    ok = rms < 0.03 and worst < 0.10 and 0.0 < swap_frac < 1.0 and mono > 0.9
    lines = [
        "REMC ladder-vs-NVT validation (LJ fluid)",
        f"device: {dev.device_kind}, backend: {jax.default_backend()}",
        f"protocol: N={N} rho={RHO}, {C} replicas T in [{T_LO}, {T_HI}], "
        f"{EQUIL} equil + {ROUNDS}x{SWEEPS} sweeps, exchange every "
        f"{SWEEPS} sweeps (alternating phases), jnp path, f32",
        f"swap fraction: {swap_frac:.3f} (must discriminate: in (0,1))",
        f"per-T energy difference REMC - NVT (per particle): "
        f"rms {rms:.4f}, worst {worst:.4f} (bounds 0.03 / 0.10)",
        f"energy monotone in T: fraction {mono:.2f} (bound 0.9)",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "remc_ladder.txt")
    with open(path, "w") as f:
        f.write(out)
    print("wrote", path)


if __name__ == "__main__":
    main()
