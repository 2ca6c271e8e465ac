"""TIP4P/2005 NPT density validation: 298.15 K and 1 bar.

Absolute end-to-end physics check of the 4-site rigid water model
(massless charged M site on the HOH bisector) through the FULL
compiled stack: sweeps at P=4, ln-V volume moves, Ewald
with box-dependent kappa/cfac/self.  TIP4P/2005's claim to fame is
reproducing the ambient density of water almost exactly (0.9979 g/cc
at 298 K / 1 bar, Abascal & Vega 2005, vs experiment 0.997) — a
literature-pinned number no part of this framework was fitted to, and
a sharper target than SPC/E's ~1.00.

Run: `python docs/validation/run_tip4p_density.py`.
Writes docs/validation/tip4p_density.txt.
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
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import tip4p2005_system
from metropolismontecarlo_tpu.utils.constants import AVOGADRO, BOLTZMANN

N_MOL = 216
N_CHAINS = 128
T = 298.15
P_BAR = 1.0e5 / BOLTZMANN * 1e-30          # 1 bar in K/Angstrom^3
M_WATER = 18.015268                         # g/mol
EQUIL_BLOCKS, PROD_BLOCKS, SWEEPS_PER_BLOCK = 50, 40, 250


def g_per_cc(n_density):
    return n_density * M_WATER / AVOGADRO * 1e24


def main():
    dev = jax.devices()[0]
    system = tip4p2005_system(N_MOL)
    params = RunParams(temperature=T, r_cut=9.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.25,
                       dphi_max=0.3, pressure=P_BAR, p_volume=0.2,
                       dv_max=0.02)
    mc = MonteCarlo(system, params)
    box0 = (N_MOL / 0.0334) ** (1.0 / 3.0)  # start at experimental density
    state = mc.init_state(jax.random.PRNGKey(42),
                          cubic_lattice(N_MOL, box0), box=box0,
                          n_chains=N_CHAINS)
    t0 = time.time()
    for b in range(EQUIL_BLOCKS):
        state, stats = mc.run_block(state, SWEEPS_PER_BLOCK, adjust=True)
        rho = g_per_cc(N_MOL / float(jnp.mean(state.box ** 3)))
        print(f"equil {b:2d}: rho = {rho:.4f} g/cc  "
              f"drift {float(stats['drift_max_rel']):.1e}", flush=True)
    dens = []
    worst_drift = 0.0
    for b in range(PROD_BLOCKS):
        state, stats = mc.run_block(state, SWEEPS_PER_BLOCK, adjust=False)
        worst_drift = max(worst_drift, float(stats["drift_max_rel"]))
        dens.append(np.asarray(N_MOL / state.box ** 3))
    rho_n = np.concatenate(dens)
    rho = g_per_cc(rho_n)
    blocks = g_per_cc(np.stack([d.mean() for d in dens]))
    mean, sem = float(rho.mean()), float(blocks.std() / np.sqrt(len(blocks)))
    ok = abs(mean - 0.9979) < max(0.02, 5 * sem) and worst_drift < 5e-5
    lines = [
        "TIP4P/2005 water NPT density validation",
        f"device: {dev.device_kind}, backend: {jax.default_backend()}",
        f"protocol: {N_MOL} waters x {N_CHAINS} chains, T = {T} K, "
        f"P = 1 bar ({P_BAR:.4e} K/A^3), Ewald, f32, jnp path (P=4) "
        f"+ ln-V volume moves",
        f"equil/production: {EQUIL_BLOCKS}/{PROD_BLOCKS} blocks x "
        f"{SWEEPS_PER_BLOCK} sweeps",
        f"density: {mean:.4f} +/- {sem:.4f} g/cc (block SEM over chains)",
        "reference values: experiment 0.997; TIP4P/2005 literature 0.9979",
        f"worst block drift: {worst_drift:.2e}",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tip4p_density.txt")
    with open(path, "w") as f:
        f.write(out)
    print("wrote", path)


if __name__ == "__main__":
    main()
