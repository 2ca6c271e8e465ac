"""SPC/E water vapor-liquid coexistence from molecular TMMC.

Flat-histogram muVT for a rigid molecular fluid with full Ewald
electrostatics: ONE transition-matrix run (mc/tmmc.TMMCMol — biased
orientational insertions/deletions with carried structure factors and
Rao-Blackwellized collection deposits) yields ln Pi(N) over the whole
density range at 500 K; the equal-basin-weight solve gives the
saturation activity and both coexistence densities, and the barrier
gives a Binder surface-tension estimate.  This is the Errington
flat-histogram workflow applied to water — a capability far beyond the
reference (NVT-only, `Ewald/main.jl`).

The sampled model is the framework's truncated one (r_cut = 6 A,
kappa = 5.6/box, no LRC) in a 13 A box, so the numbers carry
finite-size and truncation shifts vs full-Ewald literature (SPC/E at
500 K: rho_l ~ 0.83 g/cc, rho_v ~ 0.006 g/cc, gamma ~ 25 mN/m,
T_c ~ 640 K); gates are correspondingly banded, plus the exact
internal invariants (drift, structure factors, basin residual).

Protocol notes (measured in the LJ TMMC artifact): stratified walker
starts blanket the N axis so every slice deposits from block 0; a 1/3
burn-in discard removes the lattice-start pollution of the collection
matrix; the prominence-guarded basin split resists noise dimples.

Run: `python docs/validation/run_tmmc_water.py`.
Writes docs/validation/tmmc_water.txt.
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

from metropolismontecarlo_tpu.mc.tmmc import (TMMCMol, coexistence,
                                              surface_tension)
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system

T = 500.0
BOX = 13.0
CAP = 80
Z0 = 2e-4            # near the measured 500 K saturation activity
CHAINS = 128
BLOCKS, STEPS = 60, 2500
EQUIL_BLOCKS = 10
N_ORIENT = 1     # unbiased exchanges: orientational bias buys no
#   acceptance in the deep-rejection regime (measured)
G_CC = 18.01528 * 1.66053907  # (N/V A^-3) -> g/cc for water


def main():
    from metropolismontecarlo_tpu.mc.gcmc_mol import MolGCMC

    dev = jax.devices()[0]
    t0 = time.time()
    params = RunParams(strict_min_image=False, temperature=T, r_cut=6.0,
                       cutoff_mode="site", coulomb="ewald", use_lrc=False,
                       p_translate=0.5, dr_max=1.0, dphi_max=0.7)
    sys_ = spce_system(CAP)
    n_init = np.linspace(1, 70, CHAINS).astype(np.int32)

    # Phase 0: melt the stratified lattice starts at FIXED N
    # (p_exchange = 0) — the hot lattice otherwise evaporates before it
    # relaxes (the Gibbs-water lesson), draining every liquid slice and
    # leaving the collection matrix nothing to measure there
    g = MolGCMC(sys_, params, activity=Z0, p_exchange=0.0,
                dtype=jnp.float32, n_orient=1)
    st = g.init(jax.random.PRNGKey(11), box=BOX, n_init=n_init,
                n_chains=CHAINS)
    for b in range(EQUIL_BLOCKS):
        st, stats = g.run_block(st, STEPS, drift_tol=1e-3)
        if b % 3 == 0 or b == EQUIL_BLOCKS - 1:
            print(f"equil {b}: <E> {stats['energy_mean']:.0f} K "
                  f"accT {stats['acc_trans']:.3f} "
                  f"drift {stats['drift_max_rel']:.1e} "
                  f"({time.time() - t0:.0f} s)", flush=True)

    # Phase 1: transition-matrix blocks (same state pytree)
    t = TMMCMol(sys_, params, activity=Z0, p_exchange=0.4,
                dtype=jnp.float32, n_orient=N_ORIENT)
    # drift gate note: acceptance never reads the carried energy — every
    # exchange uses FRESH pose energies plus the carried structure
    # factors (gated tight below); the carried-E drift is a pure f32
    # bookkeeping diagnostic whose endpoint-relative value is inflated
    # by whole-range N excursions, so its gate is loose
    discard = BLOCKS // 4
    max_drift, max_sfac = 0.0, 0.0
    for b in range(BLOCKS):
        st, stats = t.run_block(st, STEPS)
        assert stats["sfac_err_max"] < 1e-3, stats
        max_drift = max(max_drift, stats["drift_max_rel"])
        max_sfac = max(max_sfac, stats["sfac_err_max"])
        if b == discard - 1:
            t.reset_collection()
        if b % 10 == 0 or b == BLOCKS - 1:
            print(f"block {b}: N [{stats['n_min']},{stats['n_max']}] "
                  f"mean {stats['n_mean']:.1f} "
                  f"visited {stats['visited_frac']:.2f} "
                  f"accI {stats['acc_insert']:.4f} "
                  f"accD {stats['acc_delete']:.4f} "
                  f"drift {stats['drift_max_rel']:.1e} "
                  f"({time.time() - t0:.0f} s)", flush=True)

    res = coexistence(t.lnpi(), Z0, BOX**3)
    gamma_ka2 = surface_tension(res["lnpi_coex"], BOX, T)
    gamma_mnm = gamma_ka2 * 1.380649  # K/A^2 -> mN/m
    rho_v = res["rho_vap"] * G_CC
    rho_l = res["rho_liq"] * G_CC
    cover = stats["visited_frac"]

    # temperature extension: the SAME run's per-slice energy moments
    # extrapolate ln Pi to 480 K and 520 K (first order, f32) and the
    # re-solved binodal must widen on cooling and narrow on heating
    from metropolismontecarlo_tpu.mc.tmmc import reweight_lnpi_temperature
    ext = {}
    for t_to in (480.0, 520.0):
        lp = reweight_lnpi_temperature(t.lnpi(), t.uhist, T, t_to,
                                       second_order=False)
        r = coexistence(lp, Z0, BOX**3)
        ext[t_to] = (r["z_coex"], r["rho_vap"] * G_CC,
                     r["rho_liq"] * G_CC)
    ok_ext = (ext[480.0][2] > rho_l > ext[520.0][2]
              and ext[480.0][1] < rho_v < ext[520.0][1]
              and ext[480.0][0] < res["z_coex"] < ext[520.0][0])

    ok_rho = 0.45 < rho_l < 1.0 and rho_v < 0.05 and rho_v < rho_l / 5.0
    ok_gamma = 2.0 < gamma_mnm < 60.0
    ok_resid = abs(res["dlnw"]) < 1e-6
    ok_cover = cover > 0.80
    # 0.25: the sweeps interleave with the biased
    # walkers' whole-ladder N excursions (0 <-> ~75 waters per block =
    # ~150 exchange swings of O(2e3) K each); the f32 residue of that
    # traversal, endpoint-relative, measured 6.8e-2 on a healthy run —
    # sfac (which acceptance actually reads) stays the 1e-3 gate
    ok_drift = max_drift < 0.25 and max_sfac < 1e-3
    ok = (ok_rho and ok_gamma and ok_resid and ok_cover and ok_drift
          and ok_ext)

    lines = [
        "SPC/E water vapor-liquid coexistence from molecular TMMC",
        f"device: {dev.device_kind}, backend: {jax.default_backend()}",
        f"model: SPC/E, Ewald kappa=5.6/box nk=5, r_cut=6 A, no LRC; "
        f"box={BOX} A, cap={CAP}",
        f"protocol: T={T} K, {CHAINS} stratified walkers, "
        f"{EQUIL_BLOCKS}x{STEPS} fixed-N melt + {BLOCKS}x{STEPS} TM "
        f"steps, n_orient={N_ORIENT}, 1/4 burn-in discard, f32, "
        f"z0={Z0}",
        f"z* = {res['z_coex']:.4e} A^-3",
        f"rho_vap = {rho_v:.4f} g/cc   rho_liq = {rho_l:.4f} g/cc   "
        f"(SPC/E full-Ewald lit at 500 K: ~0.006 / ~0.83)",
        f"surface tension (Binder, single box) = {gamma_mnm:.1f} mN/m "
        f"(lit ~25)",
        f"coverage {cover:.2f}; basin residual {res['dlnw']:.1e}; "
        f"max block drift {max_drift:.1e}, max sfac err {max_sfac:.1e} "
        f"(f32; acceptance reads fresh pose energies + carried sfac, "
        f"never the carried E)",
        f"T-extension (per-slice <U>, 1st order, same run): "
        f"480 K -> rho_v {ext[480.0][1]:.4f} rho_l {ext[480.0][2]:.4f}; "
        f"520 K -> rho_v {ext[520.0][1]:.4f} rho_l {ext[520.0][2]:.4f} "
        f"g/cc; binodal widens on cooling: {ok_ext}",
        f"gates: rho bands {ok_rho}, gamma 2-60 mN/m {ok_gamma}, "
        f"residual {ok_resid}, coverage>0.8 {ok_cover}, "
        f"drift/sfac {ok_drift}, T-extension {ok_ext}",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tmmc_water.txt")
    with open(path, "w") as f:
        f.write(out)
    print("wrote", path)


if __name__ == "__main__":
    main()
