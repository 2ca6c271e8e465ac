"""SPC/E liquid-vapor coexistence at 450 K by Gibbs-ensemble MC.

The two-box Gibbs ensemble finds both coexistence densities in one run:
molecular transfers (orientational-bias k-trials) equalize the chemical
potential, volume exchange equalizes the pressure, and the boxes settle
onto the binodal with no interface.  At 450 K the experimental
saturation line sits at 0.890 liquid / 0.0048 vapor g/cc; SPC/E lies a
few percent below the experimental liquid branch, and the r_cut 7.5 A
no-LRC truncation sampled here (Gibbs exchanges preclude N-dependent
tails) softens the liquid a few percent further.  NOTE (measured):
at 500 K with r_cut 6.5 the TRUNCATED model is already supercritical —
both boxes relax to one homogeneous ~0.10 g/cc phase; truncation
lowers the critical point far below the full model's 640 K.

Gates:
  * liquid branch inside [0.65, 0.88] g/cc, vapor inside (0, 0.06],
    with a real density gap (rho_l / rho_v > 8);
  * INTERNAL mu-equality via TWO-SIDED BAR: per-box ghost insertions
    AND real-molecule deletions solved with Bennett's estimator
    (mc/fep.bar_mu_ex) give beta mu = ln(rho) + beta mu_ex; both boxes
    must agree — the defining property of coexistence, no literature
    needed.  One-sided Widom is fat-tail BIASED in the dense liquid
    (round-3 measured: +0.6 beta mu at 0.86 g/cc with 1.7M ghosts —
    the bias GREW with more samples because the missing tail is
    systematic); BAR's overlap is anchored by the ~2% accepted
    transfer rate, so the tolerance can drop to ~0.2;
  * carried per-box structure factors stay consistent with the dense
    recompute (the TIGHT invariant; the f32 carried ENERGY residue
    scales with the exchange traversal, not the endpoints — see
    mc/gcmc_mol.MolGCMC.run_block).

Run: `python docs/validation/run_gibbs_water.py`.
Writes docs/validation/gibbs_water.txt.  GIBBS_N_ORIENT (default 1)
sets the transfers' Rosenbluth trial count — orientational bias buys
~nothing in the deep-rejection regime, and the BAR mu gate holds
either way.
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

from metropolismontecarlo_tpu.mc.gibbs_mol import MolGibbsEnsemble
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system
from metropolismontecarlo_tpu.utils.constants import AVOGADRO

T = 450.0
CAP = int(os.environ.get("GIBBS_CAP", 256))
M_WATER = 18.015268
N_CHAINS = int(os.environ.get("GIBBS_CHAINS", 96))
EQUIL_BLOCKS = int(os.environ.get("GIBBS_EQUIL", 3))
N_ORIENT = int(os.environ.get("GIBBS_N_ORIENT", 1))
PROD_BLOCKS = int(os.environ.get("GIBBS_PROD", 24))
BLOCK_STEPS = int(os.environ.get("GIBBS_STEPS", 6000))
# GIBBS_LRC=1 (default, round 5): sample the TAIL-CORRECTED model —
# the LJ long-range corrections enter every transfer AND
# volume acceptance (U_lrc = g(box) N^2 per box) — and gate the
# artifact model-vs-model via r_cut-INVARIANCE: two full coexistence
# measurements at r_cut 7.5 and 8.5 A must agree on rho_l, rho_v and
# dH_vap within combined error, because a correctly tail-corrected
# model's coexistence must not depend on where the LJ sum is
# truncated.  This is the strongest gate available offline: it tests
# exactly the property LRC claims to provide, with no memorized
# literature digits in the loop (a first attempt gated on recalled
# per-paper densities and the band edge turned out to be the
# uncertain quantity, not the physics).  Published-spread sanity
# windows (wide, honest) catch gross errors; experiment is reported
# for context only.  GIBBS_LRC=0 reproduces the round-4
# truncated-model artifact (single run, loose bands; its liquid
# measured 0.823 g/cc vs 0.838 with LRC at the same r_cut — the tail
# term's measured effect).
USE_LRC = os.environ.get("GIBBS_LRC", "1") == "1"
RHO_L_BAND = (0.68, 0.92)            # legacy-mode bands (GIBBS_LRC=0)
RHO_V_BAND = (0.0, 0.06)


def g_per_cc(n_density):
    return n_density * M_WATER / AVOGADRO * 1e24


def run_one(r_cut_req, seed, t0, prod_blocks):
    """One full coexistence measurement at a requested r_cut.

    Returns a dict with box-role-resolved densities (ratio of means),
    dH_vap, the two-sided-BAR mu-equality, and the drift/sfac
    invariants.  Factored so the LRC artifact can gate r_cut-INVARIANCE
    (see main)."""
    import dataclasses

    from metropolismontecarlo_tpu.mc.fep import bar_mu_ex
    from metropolismontecarlo_tpu.observables import heat_of_vaporization
    from metropolismontecarlo_tpu.ops.ewald import tune_parameters

    n_l, n_v = (2 * CAP) // 3, CAP // 6
    box_l = (n_l / (0.80 / M_WATER * AVOGADRO * 1e-24)) ** (1.0 / 3.0)
    box_v = (n_v / (0.015 / M_WATER * AVOGADRO * 1e-24)) ** (1.0 / 3.0)
    # min-image headroom: the liquid box densifies to ~18 A at 0.85
    # g/cc; keep 2*r_cut at least ~6% under that so the volume moves
    # are never biased by the wall
    r_cut = min(r_cut_req, 0.47 * box_l)
    l_max = (box_l**3 + box_v**3) ** (1.0 / 3.0)
    kl, nk, ksq = tune_parameters(l_max, r_cut, 1e-3)
    params = RunParams(temperature=T, r_cut=r_cut, cutoff_mode="site",
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       use_lrc=USE_LRC,
                       p_translate=0.5, p_volume=0.01, dr_max=0.4,
                       dphi_max=0.6)
    n_or = N_ORIENT
    g = MolGibbsEnsemble(spce_system(CAP), params, dv_max=0.03,
                         p_transfer=0.4, dtype=jnp.float32,
                         n_orient=n_or)
    st = g.init(jax.random.PRNGKey(seed), boxes=(box_l, box_v),
                n_init=(n_l, n_v), n_chains=N_CHAINS)
    print(f"r_cut {r_cut:.1f}: boxes ({box_l:.2f}, {box_v:.2f}) A, "
          f"tuned kappa_L {kl:.1f} nk {nk}", flush=True)

    # pre-equilibrate each box with exchanges OFF (see module notes:
    # a lattice liquid evaporates if transfers open immediately;
    # 12k-step device calls are the proven-stable length)
    g_eq = MolGibbsEnsemble(spce_system(CAP),
                            dataclasses.replace(params, p_volume=0.0),
                            dv_max=0.03, p_transfer=0.0,
                            dtype=jnp.float32, n_orient=8)
    for b in range(int(os.environ.get("GIBBS_PREEQ", 25))):
        st, stats = g_eq.run_block(st, 12000)
        if b % 10 == 0 or b == 24:
            print(f"  pre-eq {b}: rho_l {g_per_cc(stats['rho_liq']):.4f}"
                  f"  [{time.time() - t0:.0f} s]", flush=True)

    worst = 0.0
    for b in range(EQUIL_BLOCKS):
        st, stats = g.run_block(st, BLOCK_STEPS)
        worst = max(worst, stats["drift_max_rel"])
        print(f"  equil {b}: rho_l {g_per_cc(stats['rho_liq']):.4f}  "
              f"rho_v {g_per_cc(stats['rho_vap']):.4f}  "
              f"accX {stats['acc_transfer']:.3f}  "
              f"[{time.time() - t0:.0f} s]", flush=True)

    nsum = np.zeros(2)
    vsum = np.zeros(2)
    rls, rvs, dmu_blocks, dh_blocks = [], [], [], []
    worst_sfac = 0.0
    for b in range(prod_blocks):
        st, stats = g.run_block(st, BLOCK_STEPS)
        worst = max(worst, stats["drift_max_rel"])
        worst_sfac = max(worst_sfac, stats["sfac_err_max"])
        dh_blocks.append(float(np.mean(
            heat_of_vaporization(st, g.pressure_fd(st)))))
        assert stats["full_frac"] == 0.0, stats
        n_box = np.asarray(st.active.sum(axis=2), np.float64)
        v_box = np.asarray(st.box, np.float64) ** 3
        order = np.argsort(-(n_box / v_box), axis=1)           # liq first
        nsum += np.take_along_axis(n_box, order, 1).mean(axis=0)
        vsum += np.take_along_axis(v_box, order, 1).mean(axis=0)
        rho_b = (np.take_along_axis(n_box, order, 1).mean(axis=0)
                 / np.take_along_axis(v_box, order, 1).mean(axis=0))
        # two-sided BAR works: 6 x 256 ghost batches per block (one
        # 1024-wide batch overflows HBM at K ~ 6e3)
        di_b, ov_b, dd_b = [], [], []
        for r in range(6):
            di, ov, dd = g.widom_works(
                st, jax.random.PRNGKey(900 + 64 * seed + 16 * b + r),
                256, 256)
            o3 = order[:, :, None]
            di_b.append(np.take_along_axis(np.asarray(di, np.float64),
                                           o3, 1))
            ov_b.append(np.take_along_axis(np.asarray(ov, bool), o3, 1))
            dd_b.append(np.take_along_axis(np.asarray(dd, np.float64),
                                           o3, 1))
        bmu_b = np.empty(2)
        for role in (0, 1):
            du_i = np.concatenate([x[:, role].ravel() for x in di_b])
            ov_i = np.concatenate([x[:, role].ravel() for x in ov_b])
            du_d = np.concatenate([x[:, role].ravel() for x in dd_b])
            # widom_works returns the DELETION energy change; BAR wants
            # the molecule energy content in the (N+1) ensemble = -that
            mu_ex = bar_mu_ex(du_i, ov_i, -du_d, T)
            bmu_b[role] = np.log(rho_b[role]) + mu_ex / T
        dmu_blocks.append(bmu_b[0] - bmu_b[1])
        rls.append(g_per_cc(stats["rho_liq"]))
        rvs.append(g_per_cc(stats["rho_vap"]))

    rho = nsum / vsum
    dmu_blocks = np.asarray(dmu_blocks)
    return dict(
        r_cut=r_cut, kl=kl, nk=nk,
        rho_l=g_per_cc(rho[0]), rho_v=g_per_cc(rho[1]),
        sem_l=float(np.std(rls) / np.sqrt(len(rls))),
        sem_v=float(np.std(rvs) / np.sqrt(len(rvs))),
        dmu=float(dmu_blocks.mean()),
        sem_mu=float(dmu_blocks.std() / np.sqrt(len(dmu_blocks))),
        dh=float(np.mean(dh_blocks) * 8.31446e-3),
        sem_dh=float(np.std(dh_blocks) / np.sqrt(len(dh_blocks))
                     * 8.31446e-3),
        worst=worst, worst_sfac=worst_sfac)


def _gates_one(r, lines):
    """Per-state-point gates shared by both modes: phases separated,
    mu-equality, invariants."""
    mu_tol = max(0.2, 4.0 * r["sem_mu"])
    ok = (r["rho_l"] / max(r["rho_v"], 1e-9) > 8.0
          and abs(r["dmu"]) < mu_tol
          and r["worst_sfac"] < 1e-3 and r["worst"] < 5e-3)
    lines.append(
        f"r_cut {r['r_cut']:.1f}: rho_l {r['rho_l']:.4f} +- "
        f"{r['sem_l']:.4f}  rho_v {r['rho_v']:.4f} +- {r['sem_v']:.4f} "
        f"g/cc  dH_vap {r['dh']:.1f} +- {r['sem_dh']:.1f} kJ/mol  "
        f"dmu {r['dmu']:+.3f} +- {r['sem_mu']:.3f} (tol {mu_tol:.2f})  "
        f"sfac {r['worst_sfac']:.1e}  [{'PASS' if ok else 'FAIL'}]")
    return ok


def main():
    dev = jax.devices()[0]
    t0 = time.time()
    lines = [
        "SPC/E liquid-vapor coexistence at 450 K: Gibbs-ensemble MC",
        f"device: {dev.device_kind}, {N_CHAINS} chains x 2 boxes, "
        f"cap {CAP}, transfers = jnp Rosenbluth n_orient={N_ORIENT}, "
        "f32",
    ]
    if not USE_LRC:
        r = run_one(7.5, 3, t0, PROD_BLOCKS)
        ok = _gates_one(r, lines)
        ok = ok and RHO_L_BAND[0] < r["rho_l"] < RHO_L_BAND[1] \
            and RHO_V_BAND[0] < r["rho_v"] < RHO_V_BAND[1]
        lines += [
            "model = bare r_cut-truncated SPC/E (GIBBS_LRC=0 legacy; "
            f"loose bands rho_l {RHO_L_BAND}, rho_v {RHO_V_BAND}; "
            "truncation softens the liquid; experiment 0.890 / 0.0048 "
            "g/cc, dH 39.6 kJ/mol)",
        ]
    else:
        # PRODUCTION artifact (round-5 verdict item 2): the model-vs-
        # model standard that needs no memorized literature digits is
        # r_cut-INVARIANCE — with the LJ tail corrections in every
        # transfer/volume acceptance, the sampled coexistence must not
        # depend on where the LJ sum is truncated.  Two full
        # measurements at r_cut 7.5 and 8.5 A (independent seeds,
        # tuned Ewald each) must agree on rho_l, rho_v AND dH_vap
        # within combined error; published-spread sanity windows catch
        # gross physics errors (SPC/E GEMC/interfacial studies at
        # 450 K scatter over ~0.83-0.87 g/cc liquid — all a few
        # percent BELOW the experimental 0.890 — with vapor ~0.003-
        # 0.007 g/cc; dH_vap(SPC/E) sits a few kJ/mol under the
        # experimental 39.6).
        r1 = run_one(7.5, 3, t0, PROD_BLOCKS)
        ok1 = _gates_one(r1, lines)
        r2 = run_one(8.5, 11, t0, PROD_BLOCKS)
        ok2 = _gates_one(r2, lines)
        d_rho = abs(r2["rho_l"] - r1["rho_l"])
        tol_rho = max(4.0 * np.hypot(r1["sem_l"], r2["sem_l"]), 0.012)
        d_rv = abs(r2["rho_v"] - r1["rho_v"])
        tol_rv = max(4.0 * np.hypot(r1["sem_v"], r2["sem_v"]), 0.0012)
        d_dh = abs(r2["dh"] - r1["dh"])
        tol_dh = max(4.0 * np.hypot(r1["sem_dh"], r2["sem_dh"]), 1.2)
        inv_ok = d_rho < tol_rho and d_rv < tol_rv and d_dh < tol_dh
        win_ok = (0.80 < r2["rho_l"] < 0.90
                  and 0.002 < r2["rho_v"] < 0.010
                  and 30.0 < r2["dh"] < 42.0)
        ok = ok1 and ok2 and inv_ok and win_ok
        lines += [
            "model = SPC/E + LJ tail corrections IN every transfer/"
            "volume acceptance",
            f"r_cut-INVARIANCE (the model-vs-model gate): "
            f"|d rho_l| {d_rho:.4f} < {tol_rho:.4f}, "
            f"|d rho_v| {d_rv:.4f} < {tol_rv:.4f}, "
            f"|d dH| {d_dh:.2f} < {tol_dh:.2f} kJ/mol  "
            f"[{'PASS' if inv_ok else 'FAIL'}]",
            f"published-spread windows (rho_l (0.80, 0.90), rho_v "
            f"(0.002, 0.010) g/cc, dH (30, 42) kJ/mol; see runner "
            f"comment)  [{'PASS' if win_ok else 'FAIL'}]",
            "experiment at 450 K: 0.890 / 0.0048 g/cc, dH 39.6 kJ/mol "
            "(SPC/E sits a few percent below on the liquid branch; the "
            "residual dH gap is the MODEL's, not the truncation's — "
            "that is what the invariance gate shows)",
        ]
    lines += [
        f"protocol: {EQUIL_BLOCKS}+{PROD_BLOCKS} blocks x {BLOCK_STEPS}"
        f" steps/chain per state point, 25 pre-eq blocks x 12000",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    if os.environ.get("GIBBS_SMOKE"):
        return
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "gibbs_water_lrc.txt" if USE_LRC else "gibbs_water.txt")
    with open(path, "w") as f:
        f.write(out)
    assert ok, out


if __name__ == "__main__":
    main()
