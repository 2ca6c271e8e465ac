"""Species-blocked mixtures of single-species model Systems.

`mixture_system([(co2_system(1), 100), (spce_system(1), 1900)])` stacks
the template molecule of each part into one System with ragged species
blocks (models.system.System.species): each block keeps its own atom
count, so a mixture of 3- and 4-site molecules costs 3 or 4 atom
columns per molecule.  LJ types are the union of the parts' types; pairs
within one part keep that part's own table, pairs across parts use
Lorentz-Berthelot mixing of the diagonal parameters.  Zero-epsilon
(charge-only) types stay zero-epsilon, and one trailing zero-epsilon pad
type fills the padded slots of the narrower species.
"""

import numpy as np

from metropolismontecarlo_tpu.models.system import System


def mixture_system(parts, name="mixture"):
    """parts: [(system, count), ...] with uniform single-species systems
    (species None); molecule 0 of each is the block's template."""
    p_max = max(s.atoms_per_mol for s, _ in parts)
    offsets, t_tot = [], 0
    for s, _ in parts:
        offsets.append(t_tot)
        t_tot += s.eps_table.shape[0]
    pad = t_tot
    eps_d = np.zeros(t_tot + 1)
    sig_d = np.ones(t_tot + 1)
    for (s, _), o in zip(parts, offsets):
        n = s.eps_table.shape[0]
        eps_d[o:o + n] = np.diag(s.eps_table)
        sig_d[o:o + n] = np.diag(s.sig_table)
    eps_t = np.sqrt(eps_d[:, None] * eps_d[None, :])
    sig_t = np.where(eps_t > 0.0, 0.5 * (sig_d[:, None] + sig_d[None, :]),
                     1.0)
    for (s, _), o in zip(parts, offsets):
        n = s.eps_table.shape[0]
        eps_t[o:o + n, o:o + n] = s.eps_table
        sig_t[o:o + n, o:o + n] = s.sig_table

    body, masses, charges, type_ids, species = [], [], [], [], []
    for (s, count), o in zip(parts, offsets):
        if s.species is not None:
            raise ValueError("mixture parts must be single-species systems")
        p = s.atoms_per_mol
        widen = [(0, 0), (0, p_max - p)]
        body.append(np.repeat(np.pad(s.body[:1], widen + [(0, 0)]),
                              count, 0))
        masses.append(np.repeat(np.pad(s.masses[:1], widen), count, 0))
        charges.append(np.repeat(np.pad(s.charges[:1], widen), count, 0))
        tid = np.pad(s.type_ids[:1] + o, widen, constant_values=pad)
        type_ids.append(np.repeat(tid, count, 0).astype(np.int32))
        species.append((s.name, int(count), p))
    return System(
        n_mol=sum(c for _, c in parts), atoms_per_mol=p_max,
        body=np.concatenate(body), masses=np.concatenate(masses),
        charges=np.concatenate(charges),
        type_ids=np.concatenate(type_ids), eps_table=eps_t,
        sig_table=sig_t, name=name, species=tuple(species))
