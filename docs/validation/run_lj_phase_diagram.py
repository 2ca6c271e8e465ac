"""LJ vapor-liquid phase diagram from TMMC: coexistence curve
and critical-point estimate from four flat-histogram runs.

The canonical transition-matrix workflow (Errington 2003): at each
temperature one biased muVT run yields ln Pi(N) over the whole density
range; the equal-basin-weight solve gives (z*, rho_vap, rho_liq).
Fitting the curve with the law of rectilinear diameters and the 3-D
Ising order-parameter scaling,

    (rho_l + rho_v)/2 = rho_c + A (T_c - T)
    (rho_l - rho_v)   = B (T_c - T)^0.326

extrapolates the critical point — a full phase diagram from four runs,
no interface, no two-box sampling.  Internal gates: monotone branch
densities, basin-weight residuals ~ 0, visited-range coverage, and a
fitted (T_c, rho_c) in the physically sensible band for this truncated
model (cut LJ r_cut = 2.5, no shift, no LRC; its T_c sits between the
truncated-shifted ~1.09 and full-LJ ~1.31 values).  The T = 1.0 point
is independently cross-checked against the Gibbs ensemble in
docs/validation/tmmc_coexistence.txt.

Run: `python docs/validation/run_lj_phase_diagram.py`.
Writes docs/validation/lj_phase_diagram.txt.
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

from metropolismontecarlo_tpu.mc.tmmc import (TMMC, coexistence,
                                              surface_tension)
from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.system import RunParams

TEMPS = [0.85, 0.95, 1.00, 1.05]
BOX, CAP, Z0 = 6.0, 192, 0.03
CHAINS, STEPS = 256, 5000
BETA_ISING = 0.326


def run_one(temp, seed, keep=False):
    params = RunParams(strict_min_image=False, temperature=temp, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.4,
                       dr_max=0.35, use_lrc=False)
    t = TMMC(lj_system(1), params, activity=Z0, capacity=CAP,
             dtype=jnp.float32)
    # STRATIFIED starts: walkers blanket the N axis so the collection
    # matrix covers both basins from block 0 (a single mid start left
    # T = 0.85 at 49% coverage after 48 blocks — the dense-liquid
    # frontier advance is diffusive and slow at low T)
    n_init = np.linspace(2, CAP - 12, CHAINS).astype(np.int32)
    st = t.init(jax.random.PRNGKey(seed), box=BOX, n_init=n_init,
                n_chains=CHAINS)
    blocks = 64 if temp < 0.9 else 48
    # burn-in discard: TM deposits from walkers still on their init
    # lattice fabricate ln Pi structure at the high-N frontier (a rising
    # edge spike that hijacked the T >= 1.0 solves); the bias learned
    # during burn-in is kept, only the collection data restarts
    discard = blocks // 4
    for b in range(blocks):
        st, stats = t.run_block(st, STEPS, drift_tol=1e-3)
        if b == discard - 1:
            t.reset_collection()
    res = coexistence(t.lnpi(), Z0, BOX**3)
    res["visited"] = stats["visited_frac"]
    res["gamma"] = surface_tension(res["lnpi_coex"], BOX, temp)
    if keep:
        res["tmmc"] = t
    return res


def fit_critical(temps, rho_v, rho_l):
    """Least squares on diameters (linear) + order parameter (0.326
    scaling): returns (t_c, rho_c, A, B)."""
    from scipy.optimize import least_squares
    t = np.asarray(temps)
    dm = 0.5 * (rho_l + rho_v)
    op = rho_l - rho_v

    def resid(p):
        tc, rc, a, b = p
        dt = np.maximum(tc - t, 1e-9)
        return np.concatenate([dm - (rc + a * dt),
                               op - b * dt**BETA_ISING])

    p0 = (1.2, 0.32, 0.1, 0.55)
    sol = least_squares(resid, p0, bounds=([1.0, 0.1, 0.0, 0.0],
                                           [2.0, 0.6, 2.0, 3.0]))
    return sol.x


def main():
    dev = jax.devices()[0]
    t0 = time.time()
    results = []
    for i, temp in enumerate(TEMPS):
        r = run_one(temp, 100 + i, keep=(temp == 0.95))
        results.append(r)
        print(f"  T={temp}: z* {r['z_coex']:.5f} rho_v {r['rho_vap']:.4f} "
              f"rho_l {r['rho_liq']:.4f} visited {r['visited']:.2f} "
              f"({time.time() - t0:.0f} s)", flush=True)

    rho_v = np.asarray([r["rho_vap"] for r in results])
    rho_l = np.asarray([r["rho_liq"] for r in results])
    zs = np.asarray([r["z_coex"] for r in results])
    gam = np.asarray([r["gamma"] for r in results])
    tc, rc, a, b = fit_critical(TEMPS, rho_v, rho_l)

    mono = (np.all(np.diff(rho_v) > 0) and np.all(np.diff(rho_l) < 0)
            and np.all(np.diff(zs) > 0))
    resid_ok = all(abs(r["dlnw"]) < 1e-6 for r in results)
    cover_ok = all(r["visited"] > 0.85 for r in results)
    tc_ok = 1.05 < tc < 1.35 and 0.25 < rc < 0.40
    # Binder single-box estimate: positive, vanishing toward T_c, and
    # order-of-magnitude sane at the lowest T (full-LJ gamma(0.85) ~
    # 0.84, cut-shifted ~0.3; the cut-unshifted model sits between)
    gamma_ok = (np.all(gam > 0) and np.all(np.diff(gam) < 0)
                and 0.1 < gam[0] < 1.5)

    # temperature extension: extrapolate the T = 0.95 run's ln Pi to
    # T = 1.00 via its per-slice energy moments (first order — f32
    # collection has no usable var(U)) and re-solve coexistence; must
    # land near the DIRECT T = 1.00 row
    from metropolismontecarlo_tpu.mc.tmmc import reweight_lnpi_temperature
    t95 = results[TEMPS.index(0.95)]["tmmc"]
    lnpi_ex = reweight_lnpi_temperature(t95.lnpi(), t95.uhist, 0.95,
                                        1.00, second_order=False)
    rex = coexistence(lnpi_ex, Z0, BOX**3)
    r10 = results[TEMPS.index(1.00)]
    ex_ok = (abs(rex["rho_liq"] - r10["rho_liq"]) < 0.05
             and abs(rex["rho_vap"] - r10["rho_vap"]) < 0.02
             and abs(np.log(rex["z_coex"] / r10["z_coex"])) < 0.15)

    ok = mono and resid_ok and cover_ok and tc_ok and gamma_ok and ex_ok

    lines = [
        "LJ vapor-liquid phase diagram from TMMC",
        f"device: {dev.device_kind}, backend: {jax.default_backend()}",
        f"model: cut LJ r_cut=2.5, no shift, no LRC; box={BOX} cap={CAP}",
        f"protocol: per T, {CHAINS} stratified walkers x 48-64 x{STEPS} "
        f"steps, bias per block, 1/4 burn-in discard, f32, z0={Z0}",
        "  T      z*        rho_vap   rho_liq   gamma",
    ] + [
        f"  {t:<6} {r['z_coex']:<9.5f} {r['rho_vap']:<9.4f} "
        f"{r['rho_liq']:<9.4f} {r['gamma']:<9.4f}"
        for t, r in zip(TEMPS, results)
    ] + [
        f"branches monotone in T: {mono}; basin residuals < 1e-6: "
        f"{resid_ok}; coverage > 0.85: {cover_ok}",
        f"surface tension (Binder, single box): positive, decreasing, "
        f"gamma(0.85) in 0.1-1.5: {gamma_ok}",
        f"T-extension 0.95 -> 1.00 (per-slice <U>, 1st order): "
        f"z* {rex['z_coex']:.5f} rho_v {rex['rho_vap']:.4f} "
        f"rho_l {rex['rho_liq']:.4f} vs direct "
        f"{r10['z_coex']:.5f}/{r10['rho_vap']:.4f}/{r10['rho_liq']:.4f}"
        f": {ex_ok}",
        f"rectilinear-diameter + Ising-0.326 fit: T_c = {tc:.3f}, "
        f"rho_c = {rc:.3f} (bands 1.05-1.35 / 0.25-0.40; "
        f"truncated-shifted LJ ~1.09, full LJ ~1.31)",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lj_phase_diagram.txt")
    with open(path, "w") as f:
        f.write(out)
    print("wrote", path)


if __name__ == "__main__":
    main()
