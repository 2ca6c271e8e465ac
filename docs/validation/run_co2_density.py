"""NPT density validation: TraPPE CO2 at 240 K on the saturation line.

Absolute physics check of the rigid-LINEAR-molecule path (models/
linear.py: two LJ types with Lorentz-Berthelot cross terms + point
charges) through the full compiled NPT stack: the saturated liquid
density of CO2 at 240 K is a literature-pinned number (experiment
1088.9 kg/m^3 at P_sat = 12.83 bar) that TraPPE was fitted to
reproduce within ~1% (Potoff & Siepmann, AIChE J. 47, 1676 (2001)).
Nothing in this framework was tuned to it.

Run: `python docs/validation/run_co2_density.py`.
Writes docs/validation/co2_density.txt.
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
from metropolismontecarlo_tpu.models.linear import co2_system
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.utils.constants import AVOGADRO, BOLTZMANN

N_MOL = 256
N_CHAINS = int(os.environ.get("CO2_CHAINS", 512))
T = 240.0
P_BAR = 12.83                                # saturation pressure, bar
P = P_BAR * 1.0e5 / BOLTZMANN * 1e-30        # K / Angstrom^3
M_CO2 = 44.0095                              # g/mol
RHO_LIT = 1.0889                             # g/cc, experiment at 240 K
EQUIL_BLOCKS = int(os.environ.get("CO2_EQUIL", 40))
PROD_BLOCKS = int(os.environ.get("CO2_PROD", 20))
SWEEPS = 250


def g_per_cc(n_density):
    return n_density * M_CO2 / AVOGADRO * 1e24


def main():
    dev = jax.devices()[0]
    system = co2_system(N_MOL)
    params = RunParams(temperature=T, r_cut=10.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.3,
                       dphi_max=0.3, pressure=P, p_volume=0.2,
                       dv_max=0.02)
    mc = MonteCarlo(system, params)
    box0 = (N_MOL * M_CO2 / AVOGADRO / RHO_LIT * 1e24) ** (1.0 / 3.0)
    state = mc.init_state(jax.random.PRNGKey(24),
                          cubic_lattice(N_MOL, box0), box=box0,
                          n_chains=N_CHAINS)
    t0 = time.time()
    for b in range(EQUIL_BLOCKS):
        state, stats = mc.run_block(state, SWEEPS, adjust=True)
        rho = g_per_cc(N_MOL / float(jnp.mean(state.box ** 3)))
        if b % 5 == 0 or b == EQUIL_BLOCKS - 1:
            print(f"equil {b:2d}: rho = {rho:.4f} g/cc  "
                  f"drift {float(stats['drift_max_rel']):.1e}", flush=True)
    dens, worst = [], 0.0
    for b in range(PROD_BLOCKS):
        state, stats = mc.run_block(state, SWEEPS, adjust=False)
        worst = max(worst, float(stats["drift_max_rel"]))
        dens.append(np.asarray(N_MOL / state.box ** 3))
    rho = g_per_cc(np.concatenate(dens))
    blocks = g_per_cc(np.stack([d.mean() for d in dens]))
    mean, sem = float(rho.mean()), float(blocks.std() / np.sqrt(len(blocks)))
    ok = abs(mean - RHO_LIT) < max(0.033, 5 * sem) and worst < 5e-5
    lines = [
        "TraPPE CO2 NPT density validation (rigid linear molecules)",
        f"device: {dev.device_kind}, backend: {jax.default_backend()}",
        f"protocol: {N_MOL} CO2 x {N_CHAINS} chains, T = {T} K, "
        f"P = {P_BAR} bar (sat. line), Ewald, f32, jnp path "
        f"+ ln-V volume moves",
        f"equil/production: {EQUIL_BLOCKS}/{PROD_BLOCKS} blocks x "
        f"{SWEEPS} sweeps",
        f"density: {mean:.4f} +/- {sem:.4f} g/cc (block SEM)",
        f"reference: experiment {RHO_LIT} g/cc; TraPPE reproduces "
        f"coexistence densities within ~1%",
        f"worst block drift: {worst:.2e}",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    if os.environ.get("CO2_SMOKE"):
        return
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "co2_density.txt")
    with open(path, "w") as f:
        f.write(out)
    assert ok, out


if __name__ == "__main__":
    main()
