"""Molecular-GCMC validation: supercritical SPC/E water.

Two INDEPENDENT routes to the excess chemical potential must meet:

  * muVT route: the grand-canonical molecular app (mc/gcmc_mol.py,
    orientational-bias insertions/deletions with carried Ewald
    structure factors) samples <N> at fixed activity z, giving
    beta mu_ex = ln(z / <rho>);
  * NVT route: the main driver (sweeps) at fixed
    N = round(<N>) in the same box, with Widom ghost insertions
    (mc/widom.py) giving beta mu_ex = -ln<exp(-beta dU)>.

The two samplers share the energy model but are different ensembles,
different movers, and different estimators — agreement is an absolute
consistency check of the exchange acceptance rules (incl. the
self+intra constants and the Rosenbluth bias correction) on the
compiled path in f32.

Run: `python docs/validation/run_gcmc_water.py`.
Writes docs/validation/gcmc_water.txt.
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
from metropolismontecarlo_tpu.mc.gcmc_mol import MolGCMC
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system

# WELL-supercritical state point (SPC/E T_c ~ 640 K).  Measured: at
# 500 K any z above the tiny saturation activity ~2e-4 A^-3
# condenses and fills every slot, and even 700 K sits on a near-
# critical flat isotherm (z = 2e-3 ran away from N = 24 to 88+).  At
# 1000 K the isotherm is steep and near-ideal, so the activity pins a
# moderate density far from the capacity.
T = 1000.0
BOX = 20.0
Z = 2.5e-3          # activity, A^-3
CAP = 96
N_CHAINS = 256
N_ORIENT = 4
EQUIL_BLOCKS, PROD_BLOCKS, STEPS = 8, 8, 1500


def main():
    dev = jax.devices()[0]
    out = [f"molecular GCMC vs NVT+Widom, supercritical SPC/E, {dev.device_kind}",
           f"T = {T} K, box = {BOX} A, z = {Z} A^-3, capacity {CAP}, "
           f"{N_CHAINS} chains, n_orient = {N_ORIENT}"]
    params = RunParams(temperature=T, r_cut=10.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=1.2, dphi_max=0.7)
    g = MolGCMC(spce_system(CAP), params, activity=Z, p_exchange=0.4,
                dtype=jnp.float32, n_orient=N_ORIENT)
    st = g.init(jax.random.PRNGKey(7), box=BOX, n_init=24,
                n_chains=N_CHAINS)
    t0 = time.time()
    for b in range(EQUIL_BLOCKS):
        st, stats = g.run_block(st, STEPS)
        print(f"equil {b}: <N> {stats['n_mean']:.2f} "
              f"accI {stats['acc_insert']:.3f} accD {stats['acc_delete']:.3f} "
              f"drift {stats['drift_max_rel']:.2e}")
    n_mean = 0.0
    for b in range(PROD_BLOCKS):
        st, stats = g.run_block(st, STEPS)
        assert stats["drift_max_rel"] < 1e-4, stats
        assert stats["full_frac"] < 0.02, ("capacity saturated — not a vapor/fluid state point", stats)
        n_mean += stats["n_mean"] / PROD_BLOCKS
        print(f"prod {b}: <N> {stats['n_mean']:.2f} "
              f"full {stats['full_frac']:.3f} "
              f"drift {stats['drift_max_rel']:.2e}")
    rho = n_mean / BOX**3
    bmu_gcmc = float(np.log(Z / rho))
    out.append(f"muVT:  <N> = {n_mean:.2f} over {PROD_BLOCKS}x{STEPS} "
               f"steps/chain, rho = {rho:.3e} A^-3, "
               f"beta*mu_ex = ln(z/rho) = {bmu_gcmc:+.4f}")
    out.append(f"       final acc: insert {stats['acc_insert']:.3f}, "
               f"delete {stats['acc_delete']:.3f}, "
               f"trans {stats['acc_trans']:.3f}, rot {stats['acc_rot']:.3f}; "
               f"drift {stats['drift_max_rel']:.1e} (f32)")

    # independent NVT + Widom at the sampled density
    n = int(round(n_mean))
    mc = MonteCarlo(spce_system(n), params)
    state = mc.init_state(jax.random.PRNGKey(8), cubic_lattice(n, BOX),
                          box=BOX, n_chains=N_CHAINS)
    for _ in range(4):
        state, _ = mc.run_block(state, 100, adjust=True)
    bsum, cnt = 0.0, 0
    for i in range(6):
        state, bstats = mc.run_block(state, 50, adjust=False)
        w = mc.widom(state, jax.random.PRNGKey(200 + i), n_insertions=256)
        bsum += float(jnp.mean(w["boltzmann_mean"]))
        cnt += 1
    bmu_widom = float(-np.log(bsum / cnt))
    out.append(f"NVT:   N = {n}, Widom over {cnt}x256x{N_CHAINS} ghosts: "
               f"beta*mu_ex = {bmu_widom:+.4f} "
               f"(drift {bstats['drift_max_rel']:.1e})")
    diff = bmu_gcmc - bmu_widom
    out.append(f"difference: {diff:+.4f} kT "
               f"({'PASS' if abs(diff) < 0.1 else 'FAIL'}, bound 0.1; "
               f"finite-N rounding alone is worth ~{1.0 / n_mean:.3f})")
    out.append(f"wall time: {time.time() - t0:.0f} s")
    text = "\n".join(out) + "\n"
    print(text)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gcmc_water.txt")
    with open(path, "w") as f:
        f.write(text)
    assert abs(diff) < 0.1, text


if __name__ == "__main__":
    main()
