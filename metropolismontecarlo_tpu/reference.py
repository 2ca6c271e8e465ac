"""Plain float64 NumPy energy of one configuration: the independent
reference the JAX energy model and the carried MC energies are checked
against.

No JAX, no carried state, no structure-factor recurrences: a direct
O(A^2) pair loop (row-blocked to bound memory) with minimum image and a
SITE cutoff, which every shipped configuration uses.  Covered:

  * LJ, 4 eps ((s/r)^12 - (s/r)^6) for r < r_cut, unshifted ("none") or
    with the Mossa linear force shift ("linear");
  * the LJ tail correction (8 pi / 3V) sum_ab N_a N_b eps s^3
    [(s/rc)^9 / 3 - (s/rc)^3] over atom-type counts (unshifted only);
  * Coulomb "bare" (q q / r), "wolf" (pairwise-shifted erfc(k r)/r -
    erfc(k rc)/rc, or the reference convention's unshifted pairs plus its
    -erfc(k rc)/rc Q^2 constant, both with the Wolf self term) and
    "ewald": real-space erfc pairs, the reciprocal sum over the FULL
    k-set 0 < |n|^2 < ksq_max, |n_i| <= nk (each k counted once, no
    half-space folding), the self term, the intramolecular erf
    correction, and the optional vacuum surface term.

Energies in Kelvin, lengths in Angstrom, kappa = kappa_L / box; the
component keys match `models.energy.energy_breakdown`.
"""

import math

import numpy as np

from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR

_erfc = np.frompyfunc(math.erfc, 1, 1)


def _min_image(d, box):
    return d - box * np.round(d / box)


def _kvectors(nk, ksq_max):
    """Full-space integer k-vectors, 0 < |n|^2 < ksq_max, |n_i| <= nk."""
    r = np.arange(-nk, nk + 1)
    n = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    n2 = np.sum(n * n, axis=1)
    return n[(n2 > 0) & (n2 < ksq_max)]


def _pairs(x, mol, box, r_cut, block):
    """Yield (i, j, r) for every inter-molecular pair i < j with
    minimum-image distance r < r_cut, in row blocks."""
    A = x.shape[0]
    for i0 in range(0, A, block):
        i1 = min(A, i0 + block)
        d = _min_image(x[i0:i1, None, :] - x[None, :, :], box)
        r2 = np.sum(d * d, axis=-1)
        ii = np.arange(i0, i1)[:, None]
        jj = np.arange(A)[None, :]
        keep = (jj > ii) & (mol[ii] != mol[jj]) & (r2 < r_cut * r_cut)
        i, j = np.nonzero(keep)
        yield i + i0, j, np.sqrt(r2[i, j])


def energy_components(system, params, coords, com, box, block=256):
    """Energy components of one configuration.

    coords (A, 3) atom positions in the system's (ragged) atom order,
    com (M, 3) molecular centres (used by the surface term), box the
    cubic edge.  Returns a dict of Python floats: disp, lrc, coul_real,
    coul_fourier, coul_self, coul_intra, total.
    """
    if params.cutoff_mode != "site":
        raise NotImplementedError("the reference covers the site cutoff")
    x = np.asarray(coords, np.float64).reshape(system.n_atoms, 3)
    box = float(box)
    vol = box**3
    mol = system.atom_mol_slot[0]
    types = np.asarray(system.flat(np.asarray(system.type_ids)))
    q = np.asarray(system.flat(np.asarray(system.charges)), np.float64)
    eps_t = np.asarray(system.eps_table, np.float64)
    sig_t = np.asarray(system.sig_table, np.float64)
    out = dict(disp=0.0, lrc=0.0, coul_real=0.0, coul_fourier=0.0,
               coul_self=0.0, coul_intra=0.0)

    rc = float(params.r_cut)
    for i, j, r in _pairs(x, mol, box, rc, block):
        eps = eps_t[types[i], types[j]]
        sig = sig_t[types[i], types[j]]
        sr6 = (sig / r) ** 6
        u = 4.0 * eps * (sr6 * sr6 - sr6)
        if params.lj_shift == "linear":
            sc6 = (sig / rc) ** 6
            lam1 = 4.0 * (7.0 * sc6 - 13.0 * sc6 * sc6)
            lam2 = -24.0 * (sc6 - 2.0 * sc6 * sc6) * (sig / rc)
            u = u + eps * (lam1 + lam2 * r / sig)
        elif params.lj_shift != "none":
            raise ValueError(params.lj_shift)
        out["disp"] += float(np.sum(u))

    if params.use_lrc and params.lj_shift == "none":
        n = np.bincount(types, minlength=eps_t.shape[0]).astype(np.float64)
        sc3 = (sig_t / rc) ** 3
        c = eps_t * sig_t**3 * (sc3**3 / 3.0 - sc3)
        out["lrc"] = 8.0 * math.pi / (3.0 * vol) * float(n @ c @ n)

    style = params.coulomb
    if style != "none":
        kappa = params.kappa_L / box
        qc = float(params.qq_cut)
        real = 0.0
        for i, j, r in _pairs(x, mol, box, qc, block):
            qq = q[i] * q[j]
            if style == "bare":
                real += float(np.sum(qq / r))
            elif style in ("ewald", "wolf"):
                term = _erfc(kappa * r).astype(np.float64) / r
                if style == "wolf" and params.wolf_style == "pairwise":
                    term = term - math.erfc(kappa * qc) / qc
                real += float(np.sum(qq * term))
            else:
                raise ValueError(style)
        out["coul_real"] = COULOMB_FACTOR * real
        q2 = float(np.sum(q * q))
        if style == "wolf":
            out["coul_self"] = -COULOMB_FACTOR * q2 * (
                math.erfc(kappa * qc) / (2.0 * qc) + kappa / math.sqrt(math.pi))
            if params.wolf_style != "pairwise":
                out["coul_self"] -= COULOMB_FACTOR * math.erfc(kappa * qc) \
                    / qc * float(np.sum(q)) ** 2
        if style == "ewald":
            n = _kvectors(params.nk, params.ksq_max).astype(np.float64)
            k = (2.0 * math.pi / box) * n                        # (K, 3)
            k2 = np.sum(k * k, axis=1)
            phase = x @ k.T                                      # (A, K)
            s_re = q @ np.cos(phase)
            s_im = q @ np.sin(phase)
            coef = (2.0 * math.pi / vol) * np.exp(-k2 / (4.0 * kappa**2)) / k2
            out["coul_fourier"] = COULOMB_FACTOR * float(
                np.sum(coef * (s_re * s_re + s_im * s_im)))
            out["coul_self"] = -COULOMB_FACTOR * kappa / math.sqrt(math.pi) \
                * q2
            intra = 0.0
            starts = system.mol_a0
            for m, p in enumerate(system.mol_p):
                a0 = int(starts[m])
                for a in range(a0, a0 + int(p)):
                    for b in range(a + 1, a0 + int(p)):
                        r = float(np.linalg.norm(_min_image(x[a] - x[b], box)))
                        intra += q[a] * q[b] * math.erf(kappa * r) / r
            out["coul_intra"] = -COULOMB_FACTOR * intra
            if params.ewald_surface:
                d = _min_image(x - np.asarray(com, np.float64)[mol], box)
                dip = q @ d
                out["coul_fourier"] += COULOMB_FACTOR * 2.0 * math.pi \
                    / (3.0 * vol) * float(dip @ dip)
    out["total"] = sum(out.values())
    return out
