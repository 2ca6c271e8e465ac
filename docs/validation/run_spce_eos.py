"""SPC/E compressed-liquid equation of state in ONE run.

The per-chain pressure ladder batches eight isobars (1 to 3000 bar at
298.15 K) into a single compiled NPT program: 512 chains, 64 per
pressure, every chain sampling its own isobar.  Three gates, two of
them absolute:

  * the 1-bar density must land on the known SPC/E ambient value
    (~1.00 g/cc; experiment 0.997) — reproduces the npt_density
    artifact inside the ladder;
  * the ladder slope d(ln rho)/dP at low pressure is the isothermal
    compressibility: experiment 4.52e-5/bar at 25 C, SPC/E literature
    ~4.6e-5/bar — the EOS curvature is real physics, nothing here was
    fitted to it;
  * SELF-CONSISTENCY: the same kappa_T must come out of the
    volume-fluctuation route (<dV^2>/T<V>, observables.NPTFluctuations
    physics) computed per isobar from the very same run — the
    fluctuation-dissipation check that ties the ensemble's second
    moments to its first-moment pressure response.

Run: `python docs/validation/run_spce_eos.py`.
Writes docs/validation/spce_eos.txt.
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
from metropolismontecarlo_tpu.models.water import spce_system
from metropolismontecarlo_tpu.utils.constants import AVOGADRO, BOLTZMANN

N_MOL = 216
T = 298.15
M_WATER = 18.015268
BAR = 1.0e5 / BOLTZMANN * 1e-30            # 1 bar in K/Angstrom^3
P_BARS = np.array([1.0, 250.0, 500.0, 750.0, 1000.0, 1500.0, 2000.0,
                   3000.0])
CHAINS_PER_P = int(os.environ.get("EOS_CHAINS_PER_P", 64))
EQUIL_BLOCKS = int(os.environ.get("EOS_EQUIL", 36))
PROD_BLOCKS = int(os.environ.get("EOS_PROD", 20))
SWEEPS = 250
KAPPA_EXP = 4.52e-5                         # 1/bar, water 25 C
RHO_EXP_1BAR = 0.997


def g_per_cc(n_density):
    return n_density * M_WATER / AVOGADRO * 1e24


def main():
    dev = jax.devices()[0]
    n_chains = CHAINS_PER_P * len(P_BARS)
    ladder = np.repeat(P_BARS, CHAINS_PER_P) * BAR       # (C,) K/A^3
    system = spce_system(N_MOL)
    params = RunParams(temperature=T, r_cut=9.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.25,
                       dphi_max=0.3, pressure=None, p_volume=0.2,
                       dv_max=0.02)
    mc = MonteCarlo(system, params, pressure_ladder=jnp.asarray(ladder))
    box0 = (N_MOL / 0.0334) ** (1.0 / 3.0)
    state = mc.init_state(jax.random.PRNGKey(11),
                          cubic_lattice(N_MOL, box0), box=box0,
                          n_chains=n_chains)
    t0 = time.time()
    for b in range(EQUIL_BLOCKS):
        state, stats = mc.run_block(state, SWEEPS, adjust=True)
        if b % 6 == 0 or b == EQUIL_BLOCKS - 1:
            rho = g_per_cc(N_MOL / np.asarray(state.box) ** 3)
            by_p = rho.reshape(len(P_BARS), CHAINS_PER_P).mean(axis=1)
            print(f"equil {b:2d}: rho(1 bar) {by_p[0]:.4f}  "
                  f"rho(3 kbar) {by_p[-1]:.4f}  "
                  f"drift {float(stats['drift_max_rel']):.1e}  "
                  f"[{time.time() - t0:.0f} s]", flush=True)
    vols, worst = [], 0.0
    for b in range(PROD_BLOCKS):
        state, stats = mc.run_block(state, SWEEPS, adjust=False)
        worst = max(worst, float(stats["drift_max_rel"]))
        vols.append(np.asarray(state.box) ** 3)
    vols = np.stack(vols)                                # (B, C)
    byp = vols.reshape(PROD_BLOCKS, len(P_BARS), CHAINS_PER_P)
    v_mean = byp.mean(axis=(0, 2))                       # (P,)
    rho = g_per_cc(N_MOL / byp)                          # (B, P, CpP)
    rho_mean = (N_MOL / byp).mean(axis=(0, 2)) * M_WATER / AVOGADRO * 1e24
    rho_sem = rho.mean(axis=2).std(axis=0) / np.sqrt(PROD_BLOCKS)

    # ladder route: kappa_T = d ln rho / dP from the 1..1000 bar points
    lo = slice(0, 5)
    slope, _ = np.polyfit(P_BARS[lo], np.log(rho_mean[lo]), 1)
    # fluctuation route on the same samples, pooled per isobar
    var_v = vols.reshape(-1, len(P_BARS), CHAINS_PER_P) \
        .transpose(1, 0, 2).reshape(len(P_BARS), -1).var(axis=1)
    kappa_fluct = var_v / (T * v_mean) * BAR             # 1/bar per isobar
    kappa_fl_lo = float(np.mean(kappa_fluct[lo]))

    ok = (abs(rho_mean[0] - RHO_EXP_1BAR) < 0.015
          and abs(slope / kappa_fl_lo - 1.0) < 0.35
          and abs(slope / KAPPA_EXP - 1.0) < 0.40
          and np.all(np.diff(rho_mean) > 0.0)
          and worst < 5e-5)
    lines = [
        "SPC/E compressed-liquid EOS via a per-chain pressure ladder",
        f"device: {dev.device_kind}, {n_chains} chains = "
        f"{len(P_BARS)} isobars x {CHAINS_PER_P}, one compiled program",
        f"protocol: {N_MOL} waters, {T} K, Ewald r_cut 9 A, "
        f"{EQUIL_BLOCKS}/{PROD_BLOCKS} blocks x {SWEEPS} sweeps",
        "P(bar)   rho(g/cc)  +-sem      kappa_fluct(1/bar)",
    ] + [
        f"{p:7.0f}  {r:.4f}    {s:.4f}     {k:.2e}"
        for p, r, s, k in zip(P_BARS, rho_mean, rho_sem, kappa_fluct)
    ] + [
        f"ladder kappa_T (d ln rho/dP, 1-1000 bar) = {slope:.2e} /bar",
        f"fluctuation kappa_T (same range)         = {kappa_fl_lo:.2e} /bar",
        f"experiment 25 C                           = {KAPPA_EXP:.2e} /bar",
        f"rho(1 bar) = {rho_mean[0]:.4f} g/cc (experiment "
        f"{RHO_EXP_1BAR}; SPC/E NPT artifact 1.0038)",
        f"worst block drift: {worst:.2e}",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    if os.environ.get("EOS_SMOKE"):
        return
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "spce_eos.txt")
    with open(path, "w") as f:
        f.write(out)
    assert ok, out


if __name__ == "__main__":
    main()
