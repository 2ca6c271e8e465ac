"""Binary Gibbs-ensemble validation: CO2/N2 vapor-liquid
equilibrium at 240 K.

The two-component Gibbs ensemble (mc/gibbs_binary.py) on the TraPPE
CO2 + N2 mixture: fixed totals (90 CO2, 10 N2) in two boxes exchanging
volume and molecules of either species.  At 240 K (pure-CO2
saturation 12.8 bar, liquid 1.09 g/cc) the boxes phase-split into a
dense CO2-rich liquid and a vapor in which the supercritical N2
(T_c = 126 K) strongly concentrates — the K-factor
K_N2 = y_N2 / x_N2 >> 1 is the defining physics of flue-gas
liquefaction.

Gates: mass densities band (liquid 0.6-1.15, vapor < half liquid),
N2 vapor enrichment K_N2 > 1.5, box pressure agreement (pressure_fd:
the exact dU/dV of the sampled model per box; the vapor box's value is
the mixture bubble pressure), and drift/structure-factor invariants.  Ewald parameters are TUNED for the largest
box (the gibbs_mol lesson: the reference kappa = 5.6/box convention
makes the truncated model box-dependent and transfers drain into the
softer box; the init/block guard enforces this).

Protocol: the liquid box melts with transfers OFF first (hot lattices
evaporate unrelaxed — the Gibbs-water lesson).

Run: `python docs/validation/run_gibbs_co2_n2.py`.
Writes docs/validation/gibbs_co2_n2.txt.
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

from metropolismontecarlo_tpu.mc.gibbs_binary import BinaryGibbsEnsemble
from metropolismontecarlo_tpu.models.linear import co2_n2_system
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.ops.ewald import tune_parameters

# 240 K, not 273: the SAMPLED model truncates LJ at 7.5 A with no LRC,
# which lowers the mixture critical point by ~10% (the truncated-LJ
# rule of thumb) — measured: at 273 K the liquid evaporated to a
# near-critical 0.43 g/cc fluid over 30 blocks.  At 240 K (expt CO2
# sat: 12.8 bar, rho_l 1.09 g/cc) the truncated model is solidly
# subcritical.
T = 240.0
BOXES = (17.0, 28.0)
CAPS = (96, 16)                 # per-box slots (CO2, N2)
N_INIT = [[72, 18], [2, 8]]     # [species][box]
N_CHAINS = 64
MELT_BLOCKS, BLOCKS, STEPS = 6, 36, 2000
N_ORIENT = 4
M_CO2, M_N2 = 44.0095, 28.0134
AMU = 1.66053907


def mass_rho(n0, n1, v):
    return (n0 * M_CO2 + n1 * M_N2) * AMU / v


def main():
    dev = jax.devices()[0]
    t0 = time.time()
    kappa_l, nk, ksq = tune_parameters(33.0, 7.5, 5e-3)
    params = RunParams(strict_min_image=False, temperature=T, r_cut=7.5,
                       cutoff_mode="site", coulomb="ewald",
                       use_lrc=False, p_translate=0.5, dr_max=0.9,
                       dphi_max=0.9, p_volume=0.01, kappa_L=kappa_l,
                       nk=nk, ksq_max=ksq)
    sys_ = co2_n2_system(*CAPS)
    out = [f"binary Gibbs VLE (CO2/N2), TraPPE, {dev.device_kind}",
           f"T = {T} K, boxes {BOXES} A, totals: CO2 "
           f"{sum(N_INIT[0])}, N2 {sum(N_INIT[1])}; {N_CHAINS} chains",
           f"tuned Ewald: kappa_L {kappa_l:.2f}, nk {nk}, ksq {ksq}"]

    # phase 0: melt the lattice starts at fixed composition
    g0 = BinaryGibbsEnsemble(sys_, params, dv_max=0.0, p_transfer=0.0,
                             dtype=jnp.float32)
    st = g0.init(jax.random.PRNGKey(23), boxes=BOXES, n_init=N_INIT,
                 n_chains=N_CHAINS)
    for b in range(MELT_BLOCKS):
        st, stats = g0.run_block(st, STEPS)
        if b % 2 == 0:
            print(f"melt {b}: accD {stats['acc_disp']:.3f} "
                  f"drift {stats['drift_max_rel']:.2e} "
                  f"({time.time() - t0:.0f} s)", flush=True)

    # phase 1: full Gibbs moves
    n_or = N_ORIENT
    out.append(f"transfers: jnp Rosenbluth n_orient={n_or}")
    g = BinaryGibbsEnsemble(sys_, params, dv_max=0.04, p_transfer=0.35,
                            dtype=jnp.float32, n_orient=n_or)
    prod_from = BLOCKS // 3
    acc = {"rho_liq": [], "rho_vap": [], "x": [], "p_liq": [],
           "p_vap": []}
    # liquid-box structure: site-site RDFs (one representative site per
    # molecule — C of CO2 (type 0), M of N2 (type 3)) under the
    # activity mask, for Kirkwood-Buff integrals of the mixture
    from metropolismontecarlo_tpu.mc.gcmc_binary import binary_atom_ok
    from metropolismontecarlo_tpu.observables import (
        MaskedRDFAccumulator,
        kirkwood_buff_integral,
    )
    rdf_cc = MaskedRDFAccumulator(sys_, 0, 0, r_max=8.0, n_bins=160)
    rdf_cm = MaskedRDFAccumulator(sys_, 0, 3, r_max=8.0, n_bins=160)
    rdf_mm = MaskedRDFAccumulator(sys_, 3, 3, r_max=8.0, n_bins=160)
    for b in range(BLOCKS):
        st, stats = g.run_block(st, STEPS)
        assert stats["sfac_err_max"] < 1e-3, stats
        assert stats["drift_max_rel"] < 3e-2, stats
        n0 = jnp.sum(st.active0, axis=2).astype(jnp.float64)  # (C, 2)
        n1 = jnp.sum(st.active1, axis=2).astype(jnp.float64)
        v = np.asarray(st.box, np.float64) ** 3
        rho_m = mass_rho(np.asarray(n0), np.asarray(n1), v)   # (C, 2)
        liq = rho_m.argmax(axis=1)
        ch = np.arange(rho_m.shape[0])
        xn2 = np.asarray(n1) / np.maximum(np.asarray(n0 + n1), 1.0)
        if b >= prod_from:
            liq_j = jnp.asarray(liq)
            take = lambda arr: jnp.take_along_axis(   # noqa: E731
                arr, liq_j.reshape(-1, *([1] * (arr.ndim - 1))), 1
            )[:, 0]
            ok_l = binary_atom_ok(sys_, take(st.active0),
                                  take(st.active1))
            for rdf in (rdf_cc, rdf_cm, rdf_mm):
                rdf.update(take(st.coords), take(st.box), ok_l)
            acc["rho_liq"].append(rho_m[ch, liq].mean())
            acc["rho_vap"].append(rho_m[ch, 1 - liq].mean())
            acc["x"].append((xn2[ch, liq].mean(),
                             xn2[ch, 1 - liq].mean()))
            p = np.asarray(g.pressure_fd(st), np.float64) * 138.065
            acc["p_liq"].append(p[ch, liq].mean())
            acc["p_vap"].append(p[ch, 1 - liq].mean())
            # per-species Widom ghosts: number density and <e^-b dU>
            # per (box, species), phase-sorted — the mu-equality data
            for s, nsp in ((0, n0), (1, n1)):
                w = np.asarray(g.widom_boltzmann(
                    st, jax.random.PRNGKey(7000 + 10 * b + s), 128, s),
                    np.float64)
                rho_s = np.asarray(nsp) / v
                acc.setdefault(("w", s, "liq"), []).append(
                    w[ch, liq].mean())
                acc.setdefault(("w", s, "vap"), []).append(
                    w[ch, 1 - liq].mean())
                acc.setdefault(("rho", s, "liq"), []).append(
                    rho_s[ch, liq].mean())
                acc.setdefault(("rho", s, "vap"), []).append(
                    rho_s[ch, 1 - liq].mean())
        if b % 4 == 0 or b == BLOCKS - 1:
            print(f"blk {b}: rho_l {rho_m[ch, liq].mean():.3f} "
                  f"rho_v {rho_m[ch, 1 - liq].mean():.3f} g/cc  "
                  f"xN2 l/v {xn2[ch, liq].mean():.3f}/"
                  f"{xn2[ch, 1 - liq].mean():.3f}  "
                  f"accX {stats['acc_transfer0']:.3f}/"
                  f"{stats['acc_transfer1']:.3f}  "
                  f"accV {stats['acc_vol']:.3f}  "
                  f"drift {stats['drift_max_rel']:.1e} "
                  f"({time.time() - t0:.0f} s)", flush=True)

    rho_l = float(np.mean(acc["rho_liq"]))
    rho_v = float(np.mean(acc["rho_vap"]))
    x_l = float(np.mean([a[0] for a in acc["x"]]))
    y_v = float(np.mean([a[1] for a in acc["x"]]))
    k_n2 = y_v / max(x_l, 1e-6)

    # coexistence pressure: exact dU/dV of the sampled model per box
    # (K/A^3 -> bar), block-averaged over production; both boxes must
    # agree at the Gibbs fixed point, and the vapor box's value is the
    # mixture's bubble pressure
    nb = len(acc["p_liq"])
    p_liq = float(np.mean(acc["p_liq"]))
    p_vap = float(np.mean(acc["p_vap"]))
    p_liq_sem = float(np.std(acc["p_liq"]) / np.sqrt(nb))
    p_vap_sem = float(np.std(acc["p_vap"]) / np.sqrt(nb))
    ok_p = (abs(p_liq - p_vap) < 4 * (p_liq_sem + p_vap_sem)
            and 2.0 < p_vap < 60.0)

    # per-species mu-equality: beta mu_s = ln rho_s - ln<e^-b dU> must
    # match between the phases (the mixture-coexistence fixed point).
    # N2 ghosts into liquid CO2 converge well (small molecule); CO2
    # ghosts into its own dense liquid are fat-tailed, so CO2 is
    # reported with a looser bound
    def bmu(s, ph):
        return float(np.log(np.mean(acc[("rho", s, ph)]))
                     - np.log(np.mean(acc[("w", s, ph)])))

    dmu = [bmu(s, "liq") - bmu(s, "vap") for s in (0, 1)]
    ok_mu = abs(dmu[1]) < 0.4 and abs(dmu[0]) < 1.0

    ok_rho = 0.6 < rho_l < 1.15 and rho_v < 0.5 * rho_l
    ok_k = k_n2 > 1.5 and y_v > x_l
    ok = ok_rho and ok_k and ok_p and ok_mu

    out += [
        f"production ({BLOCKS - prod_from} blocks): rho_liq = "
        f"{rho_l:.3f} g/cc (CO2 expt ~1.09 pure at 240 K), rho_vap = "
        f"{rho_v:.3f} g/cc",
        f"N2 mole fractions: liquid x = {x_l:.4f}, vapor y = {y_v:.4f}"
        f"; K_N2 = y/x = {k_n2:.1f} (supercritical N2 concentrates in "
        f"the vapor)",
        f"coexistence pressure (dU/dV per box, production-averaged): liquid "
        f"{p_liq:.1f} +- {p_liq_sem:.1f} bar, vapor {p_vap:.1f} +- "
        f"{p_vap_sem:.1f} bar (pure-CO2 expt P_sat(240 K) = 12.8; the "
        f"N2 raises the bubble pressure, truncation lowers it)",
        f"per-species mu-equality (Widom, liq - vap): CO2 "
        f"{dmu[0]:+.3f} kT (fat-tailed liquid ghosts, bound 1.0), N2 "
        f"{dmu[1]:+.3f} kT (bound 0.4) — the mixture-coexistence fixed "
        f"point",
        "liquid-box Kirkwood-Buff integrals (site-site masked RDFs "
        "to r = 8 A; reported, not gated): "
        + ", ".join(
            f"G_{k} = {kirkwood_buff_integral(*rdf.result()):.0f} A^3"
            for k, rdf in (("CO2-CO2", rdf_cc), ("CO2-N2", rdf_cm),
                           ("N2-N2", rdf_mm))),
        f"gates: density bands {ok_rho}; N2 vapor enrichment K > 1.5 "
        f"{ok_k}; box pressure agreement + 2-60 bar {ok_p}; "
        f"mu-equality {ok_mu}",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    text = "\n".join(out) + "\n"
    print(text)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gibbs_co2_n2.txt")
    with open(path, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
