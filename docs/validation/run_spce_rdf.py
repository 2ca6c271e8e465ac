"""Regenerate spce_oo_rdf_wolf_vs_ewald.txt: SPC/E 750-water O-O RDF,
Ewald vs Wolf overlay (the reference's own cross-check,
`Ewald/SPC_E water RDF - Wolf & Ewald.png`,
`Ewald/readme.md:30-32`).

Run: `python docs/validation/run_spce_rdf.py`.
Writes docs/validation/spce_oo_rdf_wolf_vs_ewald.txt.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import jax

from metropolismontecarlo_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_from_nist
from metropolismontecarlo_tpu.observables import RDFAccumulator

REF = "Ewald/coord750.txt"
CHAINS = 256
EQUIL_SWEEPS = 10 * 20     # 10 blocks of 20 with step-size adjust
PROD_SWEEPS = 120
HERE = os.path.dirname(os.path.abspath(__file__))


def rdf_for(coulomb):
    system, coords, com, box = spce_from_nist(REF)
    params = RunParams(temperature=298.15, r_cut=10.0, cutoff_mode="site",
                       coulomb=coulomb, p_translate=0.5, dr_max=0.3,
                       dphi_max=0.3)
    mc = MonteCarlo(system, params, dtype=jnp.float32)
    state = mc.init_from_coords(jax.random.PRNGKey(7), coords, com, box,
                                n_chains=CHAINS)
    for _ in range(10):
        state, stats = mc.run_block(state, 20, adjust=True)
    acc = RDFAccumulator(system, type_i=0, type_j=0, r_max=10.0,
                         n_bins=100)
    for _ in range(PROD_SWEEPS // 20):
        state, stats = mc.run_block(state, 20)
        acc.update(state)
    print(coulomb, "final block:", {k: round(float(stats[k]), 4)
                                    for k in ("acc_trans", "acc_rot",
                                              "drift_max_rel")})
    return acc.result()


def main():
    r, g_ewald = rdf_for("ewald")
    _, g_wolf = rdf_for("wolf")
    out = os.path.join(HERE, "spce_oo_rdf_wolf_vs_ewald.txt")
    hdr = (f"SPC/E 750-water O-O RDF at 298.15 K ({CHAINS} chains x "
           f"{PROD_SWEEPS} production sweeps each)\n"
           "r[A]  g_Ewald(r)  g_Wolf(r)")
    np.savetxt(out, np.column_stack([np.asarray(r), np.asarray(g_ewald),
                                     np.asarray(g_wolf)]), header=hdr)
    i_pk = int(np.argmax(np.asarray(g_ewald)))
    diff = float(np.max(np.abs(np.asarray(g_ewald) - np.asarray(g_wolf))
                        [np.asarray(r) > 2.5]))
    print(f"first peak r={float(r[i_pk]):.2f} g={float(g_ewald[i_pk]):.2f}"
          f"  max|dg| beyond core = {diff:.3f}")
    assert 2.6 < float(r[i_pk]) < 2.9 and 2.2 < float(g_ewald[i_pk]) < 3.2
    assert diff < 0.3
    print("wrote", out)


if __name__ == "__main__":
    main()
