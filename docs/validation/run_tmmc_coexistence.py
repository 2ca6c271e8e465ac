"""LJ vapor-liquid coexistence two ways: TMMC vs Gibbs ensemble.

Transition-matrix MC (mc/tmmc.py) and the Gibbs ensemble (mc/gibbs.py)
are COMPLETELY different algorithms — one reconstructs the macrostate
free-energy profile ln Pi(N) from a biased single-box muVT run and
locates coexistence by equal basin weights; the other equilibrates two
boxes exchanging particles and volume with no free energy anywhere.
They share only the model (cut LJ, r_cut = 2.5, no LRC, T = 1.0), so
agreement of the coexistence densities is a stringent cross-validation
of both: the collection-matrix estimator, bias handling, and
equal-weight solver on one side; the transfer/volume acceptance rules
on the other.  (Small residual differences are physical finite-size
effects: TMMC at V = 216 vs Gibbs at total V ~ 725.)

Also reported: beta mu at coexistence from ln z* (TMMC) vs the Gibbs
boxes' Widom insertion averages — a chemical-potential consistency
line across algorithms.

Run: `python docs/validation/run_tmmc_coexistence.py`.
Writes docs/validation/tmmc_coexistence.txt.
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

from metropolismontecarlo_tpu.mc.gibbs import GibbsEnsemble
from metropolismontecarlo_tpu.mc.tmmc import TMMC, coexistence
from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.system import RunParams

TEMP = 1.0
# --- TMMC side ---
BOX, CAP, Z0 = 6.0, 192, 0.03
TM_CHAINS, TM_BLOCKS, TM_STEPS = 256, 48, 5000
# --- Gibbs side (the configs/gibbs_lj.json state point) ---
G_BOX, G_INIT, G_CAP = 7.13, 108, 256
G_CHAINS, G_EQUIL, G_BLOCKS, G_STEPS = 64, 6, 8, 10000


def run_tmmc():
    params = RunParams(strict_min_image=False, temperature=TEMP, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.4,
                       dr_max=0.35, use_lrc=False)
    t = TMMC(lj_system(1), params, activity=Z0, capacity=CAP,
             dtype=jnp.float32)
    # mid-range start: walkers diffuse toward BOTH basins at once
    st = t.init(jax.random.PRNGKey(0), box=BOX, n_init=96,
                n_chains=TM_CHAINS)
    for b in range(TM_BLOCKS):
        st, stats = t.run_block(st, TM_STEPS, drift_tol=1e-3)
        if b % 8 == 7:
            print(f"  tmmc block {b}: N [{stats['n_min']},"
                  f"{stats['n_max']}] visited {stats['visited_frac']:.2f}",
                  flush=True)
    lnpi = t.lnpi()
    fin = np.where(np.isfinite(lnpi))[0]
    print(f"  tmmc ln Pi spans N = {fin[0]} .. {fin[-1]}", flush=True)
    res = coexistence(lnpi, Z0, BOX**3)
    return res, stats


def run_gibbs():
    params = RunParams(strict_min_image=False, temperature=TEMP, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.6,
                       p_volume=0.02, dr_max=0.35, use_lrc=False)
    g = GibbsEnsemble(lj_system(1), params, capacity=G_CAP, dv_max=0.03,
                      dtype=jnp.float32)
    st = g.init(jax.random.PRNGKey(1), boxes=(G_BOX, G_BOX),
                n_init=(G_INIT, G_INIT), n_chains=G_CHAINS)
    for _ in range(G_EQUIL):
        st, _ = g.run_block(st, G_STEPS)
    # ratio-of-means densities (mean-of-ratios has a Jensen bias from
    # small-box volume fluctuations) over the liquid/vapor split
    n_l = n_v = v_l = v_v = 0.0
    w_l, w_v = [], []
    for b in range(G_BLOCKS):
        st, stats = g.run_block(st, G_STEPS, drift_tol=1e-3)
        n = np.asarray(jnp.sum(st.active, axis=2), np.float64)  # (C,2)
        v = np.asarray(st.box, np.float64) ** 3
        liq = np.argmax(n / v, axis=1)     # which slot is the liquid,
        idx = np.arange(n.shape[0])        # per chain (roles can swap)
        n_l += n[idx, liq].sum();  v_l += v[idx, liq].sum()
        n_v += n[idx, 1 - liq].sum();  v_v += v[idx, 1 - liq].sum()
        w = np.asarray(g.widom_boltzmann(st, jax.random.fold_in(
            jax.random.PRNGKey(2), b), 64), np.float64)  # (C, 2)
        w_l.append(w[idx, liq]);  w_v.append(w[idx, 1 - liq])
    rho_l, rho_v = n_l / v_l, n_v / v_v
    w = np.asarray([np.mean(w_l), np.mean(w_v)])   # [liquid, vapor]
    return rho_v, rho_l, w, stats


def main():
    dev = jax.devices()[0]
    t0 = time.time()
    res, tm_stats = run_tmmc()
    t_tm = time.time() - t0
    rho_v_g, rho_l_g, wid, g_stats = run_gibbs()
    t_g = time.time() - t0 - t_tm

    # chemical potential consistency: TMMC ln z* vs Gibbs Widom,
    # beta mu = ln(rho_box) - ln <exp(-beta dU)>_box (reduced units,
    # Lambda = 1 so z = exp(beta mu)); wid = [liquid, vapor] paired by
    # density per chain inside run_gibbs
    bmu_tm = float(np.log(res["z_coex"]))
    bmu_g_liq = float(np.log(rho_l_g) - np.log(wid[0]))
    bmu_g_vap = float(np.log(rho_v_g) - np.log(wid[1]))

    d_v = abs(res["rho_vap"] - rho_v_g)
    d_l = abs(res["rho_liq"] - rho_l_g)
    ok = (d_l < 0.05 and d_v < 0.02
          and abs(bmu_tm - bmu_g_vap) < 0.25
          and tm_stats["visited_frac"] > 0.8)
    lines = [
        "LJ vapor-liquid coexistence: TMMC vs Gibbs ensemble",
        f"device: {dev.device_kind}, backend: {jax.default_backend()}",
        f"model: cut LJ r_cut=2.5, no shift, no LRC, T={TEMP}",
        f"TMMC: box={BOX} cap={CAP} z0={Z0}, {TM_CHAINS} walkers x "
        f"{TM_BLOCKS}x{TM_STEPS} steps, bias refreshed per block, f32; "
        f"visited {tm_stats['visited_frac']:.2f} of N-range, "
        f"{t_tm:.0f} s",
        f"Gibbs: boxes {G_BOX}^3 x2, N={2 * G_INIT}, {G_CHAINS} chains x "
        f"{G_BLOCKS}x{G_STEPS} steps after {G_EQUIL} equil blocks, "
        f"ratio-of-means densities, {t_g:.0f} s",
        f"rho_vap: TMMC {res['rho_vap']:.4f} vs Gibbs {rho_v_g:.4f} "
        f"(|d| {d_v:.4f} < 0.02)",
        f"rho_liq: TMMC {res['rho_liq']:.4f} vs Gibbs {rho_l_g:.4f} "
        f"(|d| {d_l:.4f} < 0.05)",
        f"beta*mu at coexistence: TMMC ln z* = {bmu_tm:.3f} vs Gibbs "
        f"Widom (vapor box) {bmu_g_vap:.3f}, (liquid box) "
        f"{bmu_g_liq:.3f} (vapor-box bound 0.25)",
        f"TMMC z* = {res['z_coex']:.5f}, equal-weight residual "
        f"{res['dlnw']:.1e}",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tmmc_coexistence.txt")
    with open(path, "w") as f:
        f.write(out)
    print("wrote", path)


if __name__ == "__main__":
    main()
