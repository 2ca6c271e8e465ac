"""Pair-interaction masks and distance grids (dense, branch-free).

The reference evaluates pair energies with early-exit scalar loops over
molecules with a molecular center-of-mass cutoff prefilter
(`Ewald/energy.jl:242-287`, `Ewald/ewalds.jl:293-376`).  On an
accelerator the equivalent is a dense distance grid with a multiplicative include-mask:
every pair is computed, excluded pairs contribute exactly zero.  Masks are
built so that no excluded pair can produce inf/nan before masking.

Cutoff conventions (`mode`):
  * "com"   — include ALL atom pairs of a molecule pair iff the molecular
              center-of-mass minimum-image distance < r_cut (the reference's
              live convention; its atomic `r^2 < r_cut^2 + 100` test is
              inert, `Ewald/energy.jl:270`).
  * "first" — same, but keyed on the first atom of each molecule (the O
              site for water; NIST's convention for the SPC/E reference
              configurations).
  * "site"  — plain atom-atom spherical cutoff.
"""

import jax.numpy as jnp

from metropolismontecarlo_tpu.ops.pbc import min_image, min_image_dist2


def molecule_key_points(coords_mpa, com, mode):
    """Per-molecule cutoff key point. coords_mpa: (..., M, P, 3), com (..., M, 3)."""
    if mode == "com":
        return com
    if mode == "first":
        return coords_mpa[..., :, 0, :]
    raise ValueError(f"no molecular key point for cutoff mode {mode!r}")


def full_pair_mask(coords, com, n_mol, box, r_cut, mode, mol_id=None):
    """(A, A) include-mask for a full-system pair sum.

    coords: (A, 3), molecule-major atom order.
    com:    (M, 3) molecular key points (COM or first-atom, per `mode`).
    mol_id: (A,) molecule index per atom; derived assuming uniform width
            A = n_mol * P when omitted (ragged systems must pass it).
    Excludes intramolecular pairs and the diagonal; applies the cutoff.
    Returns a bool mask.
    """
    A = coords.shape[0]
    if mol_id is None:
        mol_id = jnp.repeat(jnp.arange(n_mol), A // n_mol)
    inter = mol_id[:, None] != mol_id[None, :]
    if mode == "site":
        d2 = min_image_dist2(coords[:, None, :], coords[None, :, :], box)
        incl = inter & (d2 < r_cut * r_cut)
    else:
        d2m = min_image_dist2(com[:, None, :], com[None, :, :], box)
        mcut = d2m < r_cut * r_cut
        # expand (M, M) -> (A, A) via one-hot matmuls, NOT mcut[mol_id]
        # [:, mol_id] (a traced (A, A) gather; see models/energy.py
        # pair-table note).  Each output picks exactly one 0/1 element,
        # so any matmul precision is exact.
        onehot = (mol_id[:, None] == jnp.arange(mcut.shape[0])[None, :]) \
            .astype(coords.dtype)
        incl = inter & ((onehot @ (mcut.astype(coords.dtype) @ onehot.T))
                        > 0.5)
    return incl


def moved_pair_mask(ra_key, coords, com, mol_index, n_mol, box, r_cut, mode):
    """(P, A) include-mask for one moved molecule against the system.

    ra_key: (3,) the moved molecule's key point (COM or first atom).
    coords: (A, 3) current positions of all atoms (including molecule
            `mol_index`'s stale rows — they are masked out).
    com:    (M, 3) key points of all molecules.
    Returns an (A,) bool mask, broadcastable over the moved-atom axis (the
    cutoff is molecular, so it is identical for every atom of the moved
    molecule).
    """
    A = coords.shape[0]
    P = A // n_mol
    mol_id = jnp.repeat(jnp.arange(n_mol), P)
    other = mol_id != mol_index
    if mode == "site":
        raise NotImplementedError(
            "per-move site cutoff requires the moved atom coords; "
            "use moved_pair_mask_site"
        )
    d2m = min_image_dist2(ra_key[None, :], com, box)  # (M,)
    incl = other & (d2m < r_cut * r_cut)[mol_id]
    return incl


def moved_pair_mask_site(ra, coords, mol_index, n_mol, box, r_cut):
    """(P, A) site-cutoff include-mask for moved atoms ra (P, 3)."""
    A = coords.shape[0]
    P = A // n_mol
    mol_id = jnp.repeat(jnp.arange(n_mol), P)
    other = mol_id != mol_index
    d2 = min_image_dist2(ra[:, None, :], coords[None, :, :], box)
    return other[None, :] & (d2 < r_cut * r_cut)


def pair_dist2(ra, rb, box):
    """Squared minimum-image distances (P, A) between ra (P,3) and rb (A,3),
    floored at 1e-4 A^2 — the SAME floor as every move path — so that
    near-coincident pairs give finite (huge) energies rather than an f32
    inf that a zero-epsilon pad pair would turn into 0*inf = NaN."""
    dr = min_image(ra[:, None, :] - rb[None, :, :], box)
    d2 = jnp.sum(dr * dr, axis=-1)
    return jnp.maximum(d2, jnp.asarray(1e-4, d2.dtype)), dr
