"""SPC/E static dielectric constant at 298.15 K.

Absolute physics check of the dipole-fluctuation machinery
(`observables.DipoleAccumulator` + Neumann tinfoil formula): the SPC/E
dielectric constant is a heavily replicated literature number —
eps ~ 68-73 under conducting (tinfoil) boundaries (Reddy & Berkowitz,
J. Chem. Phys. 90, 3483 (1989): 71; later long-run MD studies: 68-71;
Kirkwood factor g_K follows from eps via eps - 1 = 3 y g_K).  Nothing in this framework was fitted
to it, and the convergence is notoriously slow in serial runs — here
the chain ensemble (many independent Markov chains pooled on one
device) is exactly the data-parallel answer: <M^2> converges with
chains x samples, not wall-clock.

The reference (`Ewald/`) has no dielectric machinery;
its Ewald sums implicitly use tinfoil boundaries (no surface term,
`ewalds.jl:836-844` disabled), which is the convention this number
validates.

Run: `python docs/validation/run_spce_dielectric.py`.
Writes docs/validation/spce_dielectric.txt.
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
from metropolismontecarlo_tpu.observables import DipoleAccumulator

N_MOL = 216          # box 18.64 A at 0.998 g/cc; r_cut 9 min-image-legal
N_CHAINS = 2048
T = 298.15
RHO_G_CC = 0.998     # experimental ambient density
M_WATER = 18.015268
# the collective dipole relaxes over ~thousands of sweeps PER CHAIN:
# pooling 2048 chains shrinks the statistical error but NOT the shared
# equilibration bias of the lattice/random-quat start (30 equil blocks:
# eps climbing 57.9 -> 62.1 through production; 150 blocks: 64.6 ->
# 65.6, still climbing ~ +1/7500 sweeps).  600 blocks (30k sweeps/
# chain) lets each chain's collective dipole decorrelate from its
# start before sampling opens.
EQUIL_BLOCKS, PROD_BLOCKS, SWEEPS_PER_BLOCK = 600, 150, 50


def main():
    dev = jax.devices()[0]
    system = spce_system(N_MOL)
    n_dens = RHO_G_CC / M_WATER * 6.02214076e23 * 1e-24   # 1/A^3
    box = (N_MOL / n_dens) ** (1.0 / 3.0)
    params = RunParams(temperature=T, r_cut=9.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.25,
                       dphi_max=0.3)
    mc = MonteCarlo(system, params)
    state = mc.init_state(jax.random.PRNGKey(7), cubic_lattice(N_MOL, box),
                          box=box, n_chains=N_CHAINS)
    t0 = time.time()
    for b in range(EQUIL_BLOCKS):
        state, stats = mc.run_block(state, SWEEPS_PER_BLOCK, adjust=b < 20)
        if b % 10 == 0:
            print(f"equil {b:3d}: dr_max {float(stats['dr_max_mean']):.3f} "
                  f"drift {float(stats['drift_max_rel']):.1e}", flush=True)
    dip = DipoleAccumulator(system)
    # eps running trace: recompute from the accumulator every 10 blocks
    trace = []
    worst_drift = 0.0
    for b in range(PROD_BLOCKS):
        state, stats = mc.run_block(state, SWEEPS_PER_BLOCK, adjust=False)
        worst_drift = max(worst_drift, float(stats["drift_max_rel"]))
        dip.update(state)
        if (b + 1) % 10 == 0:
            r = dip.result()
            trace.append((b + 1, r["epsilon"], r["g_kirkwood"]))
            print(f"prod {b + 1:4d}/{PROD_BLOCKS}: eps = {r['epsilon']:.1f} "
                  f"g_K = {r['g_kirkwood']:.2f} "
                  f"({r['n_samples']} samples)", flush=True)
    res = dip.result()
    # block SEM over the running-trace increments is not independent;
    # estimate uncertainty from the last-half vs full-run difference
    eps, g_k = res["epsilon"], res["g_kirkwood"]
    half = abs(trace[len(trace) // 2][1] - eps)
    # PASS requires (a) landing INSIDE the quoted literature band (with
    # a +-0.5 statistical margin) — a PASS stamp outside its own band
    # is worthless — and (b) no systematic climb across the production
    # trace: the under-equilibrated runs' signature was a MONOTONE
    # climb of ~+1 per 150 blocks (57.9->62.1, then 64.6->65.6), while
    # a converged trace wobbles +-0.4 without net direction
    climb = abs(trace[-1][1] - trace[0][1])
    # dipole density y = (eps - 1) / (3 g_K) by the tinfoil relation —
    # recovered from the accumulator's own outputs so the printed g_K
    # band stays consistent with the eps band by construction
    y = (eps - 1.0) / (3.0 * g_k)
    ok = 67.5 < eps < 73.5 and climb < 0.5 and worst_drift < 5e-5
    lines = [
        "SPC/E static dielectric constant (tinfoil BC)",
        f"device: {dev.device_kind}, backend: {jax.default_backend()}",
        f"protocol: {N_MOL} waters x {N_CHAINS} chains, T = {T} K, "
        f"rho = {RHO_G_CC} g/cc (NVT), Ewald, f32, jnp path",
        f"equil/production: {EQUIL_BLOCKS}/{PROD_BLOCKS} blocks x "
        f"{SWEEPS_PER_BLOCK} sweeps, dipoles sampled once per block",
        f"samples: {res['n_samples']} (chains x blocks)",
        f"epsilon = {eps:.1f}  (half-run delta {half:.1f}, "
        f"production-trace climb {climb:+.1f})",
        f"g_kirkwood = {g_k:.2f}  (band {0.95 * (67.0 - 1.0) / (3.0 * y):.2f}"
        f"-{1.05 * (73.0 - 1.0) / (3.0 * y):.2f}, derived)",
        "literature: eps(SPC/E) ~ 68-73 tinfoil (Reddy-Berkowitz, "
        "J. Chem. Phys. 90, 3483 (1989): 71).  The g_K band is DERIVED "
        "from that eps band via the tinfoil relation eps - 1 = 3 y g_K "
        f"at this run's dipole-density y = {y:.2f} (+-5% margin): a "
        "separately quoted literature g_K range would double-count the "
        "same measurement, and the 2.9-3.3 figure quoted through round 3 "
        "corresponds to eps ~ 55-63 — inconsistent with its own eps band "
        "(round-4 fix).",
        "running trace (blocks, eps, g_K): "
        + "; ".join(f"({b}, {e:.1f}, {g:.2f})" for b, e, g in trace),
        f"worst block drift: {worst_drift:.2e}",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "spce_dielectric.txt")
    with open(path, "w") as f:
        f.write(out)
    print("wrote", path)


if __name__ == "__main__":
    main()
