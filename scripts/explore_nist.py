"""Exploration: compute SPC/E energy splits for the NIST sample configs
under different cutoff conventions, to pin down the convention that
reproduces the NIST golden values before baking the test."""

import os

os.environ["JAX_ENABLE_X64"] = "1"
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import jax.numpy as jnp

from metropolismontecarlo_tpu.io.configs import read_nist
from metropolismontecarlo_tpu.ops import ewald, lj, tail
from metropolismontecarlo_tpu.ops.pairs import full_pair_mask, pair_dist2
from metropolismontecarlo_tpu.ops.quaternions import center_of_mass
from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR

SIG = 3.16555789
EPS = 78.19743111
QO, QH = -0.8476, 0.4238
RC = 10.0

GOLD = {  # E/kB in K, NIST SRSW SPC/E reference calcs
    1: dict(disp=9.95387e04, lrc=-8.23715e02, real=-5.58889e05,
            fourier=6.27009e03, self=-2.84469e06, intra=2.80999e06,
            total=-4.88604e05),
    2: dict(disp=1.93712e05, lrc=-3.29486e03, real=-1.19295e06,
            fourier=6.03495e03, self=-5.68938e06, intra=5.61998e06,
            total=-1.06590e06),
    3: dict(disp=3.54344e05, lrc=-7.41343e03, real=-1.96297e06,
            fourier=5.24461e03, self=-8.53407e06, intra=8.42998e06,
            total=-1.71488e06),
    4: dict(disp=4.48593e05, lrc=-1.37286e04, real=-3.57226e06,
            fourier=7.58785e03, self=-1.42235e07, intra=1.41483e07,
            total=-3.20501e06),
}


def breakdown(path, cutoff_mode, strict, site_cutoff_lj, site_cutoff_real):
    coords, species, box = read_nist(path)
    A = coords.shape[0]
    M = A // 3
    coords = jnp.asarray(coords)
    charges = jnp.asarray([QO if s == "O" else QH for s in species])
    # LJ types: O=0 (eps), H=1 (zero)
    tid = np.asarray([0 if s == "O" else 1 for s in species])
    eps_t = jnp.asarray([[EPS, 0.0], [0.0, 0.0]])
    sig_t = jnp.asarray([[SIG, 1.0], [1.0, 1.0]])
    eps_pair = eps_t[tid][:, tid]
    sig_pair = sig_t[tid][:, tid]
    masses = jnp.asarray([15.999, 1.008, 1.008] * M)
    com = center_of_mass(coords.reshape(M, 3, 3), masses.reshape(M, 3))
    kappa = 5.6 / box

    key = com if cutoff_mode == "com" else coords.reshape(M, 3, 3)[:, 0, :]
    mask = full_pair_mask(coords, key, M, box, RC,
                          "site" if cutoff_mode == "site" else "com")
    d2, dr = pair_dist2(coords, coords, box)
    # molecular COM displacement grid for virial — skip (energy only here)
    pot, _ = lj.lj_masked_sum(d2, dr, dr, mask, eps_pair, sig_pair, RC,
                              "none", site_cutoff_lj)
    e_disp = float(pot) / 2.0

    qq = charges[:, None] * charges[None, :]
    if site_cutoff_real:
        rmask = mask & (d2 < RC * RC)
    else:
        rmask = mask
    e_real = float(ewald.real_space_sum(d2, qq, rmask, kappa)) / 2.0

    kv, w = ewald.make_kvectors(5, 27, strict=strict)
    cf = ewald.cfac_coeffs(kv, w, kappa, box)
    S = ewald.structure_factor(coords, charges, kv, box)
    e_four = float(ewald.recip_energy(S, cf))

    e_self = float(ewald.ewald_self(charges, kappa))
    e_intra = float(ewald.ewald_intra(coords.reshape(M, 3, 3),
                                      charges.reshape(M, 3), kappa, box))
    e_lrc = float(tail.lrc_energy(jnp.asarray([float(M), 2.0 * M]),
                                  eps_t, sig_t, RC, box**3))
    tot = e_disp + e_lrc + e_real + e_four + e_self + e_intra
    return dict(disp=e_disp, lrc=e_lrc, real=e_real, fourier=e_four,
                self=e_self, intra=e_intra, total=tot)


ref = os.path.join(os.environ.get("MMC_REFERENCE_DIR", "reference"),
                   "Ewald", "spce_sample_config_periodic%d.txt")
import sys
paths = {1: ref % 1, 2: ref % 2, 3: ref % 3, 4: ref % 4}
for c in [1, 2, 3, 4]:
    r = breakdown(paths[c], "site", True, True, True)
    g = GOLD[c]
    rel = {k: (r[k] - g[k]) / abs(g[k]) for k in g}
    print(f"config {c}:")
    for k in g:
        flag = "OK " if abs(rel[k]) < 2e-6 else "BAD"
        print(f"   {flag} {k:8s} got={r[k]:+.6e} gold={g[k]:+.6e} rel={rel[k]:+.2e}")
