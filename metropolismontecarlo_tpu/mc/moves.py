"""Single-molecule MC move kernels: proposal, delta energy, Metropolis.

The data-parallel re-design of the reference's hot loop body
(`Ewald/main.jl:490-639`): instead of one molecule mutated in place with
early-exit energy loops, every chain advances one move per call with

  * branchless proposals: BOTH the translation and the rotation are formed
    and `where`-selected by the per-chain move-type draw,
  * ONE stacked (2P, A) masked pair grid evaluating the old and new
    positions together as fused jnp ops (XLA fuses the masked grid and
    its row sums into a few reduction kernels),
  * the Ewald reciprocal delta via carried structure factors, O(P*K)
    (the reference's RecipMove trick, `Ewald/ewalds.jl:718-826`),
  * accept/reject as `jnp.where` selection — no copy-backs.

The virial is intentionally NOT accumulated per move: pressure is an
observable, sampled from the exact full recompute at block boundaries
(driver.run_block).  The same ops functions back the full-system
recompute (models.energy), so accumulated deltas and recomputed totals
agree to roundoff (the drift invariant, reference `Poly/main.jl:232-235`).

Atom storage is the padded transposed layout (C, 3, A_pad); padding
columns carry molecule id -1 and are excluded by every mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import erfc as _erfc

from metropolismontecarlo_tpu.ops import ewald as ewald_ops
from metropolismontecarlo_tpu.ops.pbc import min_image, wrap
from metropolismontecarlo_tpu.ops.quaternions import (
    random_rotate_quaternion,
    rotate_vectors,
)
from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR


def _coulomb_pair(qq2, r, kappa, params):
    """Per-pair Coulomb energies for the jnp move paths (style dispatch
    mirrors models.energy; the wolf 'reference' convention's global
    constant cancels in per-move deltas — ops.wolf)."""
    if params.coulomb == "ewald":
        return qq2 * _erfc(kappa * r) / r
    if params.coulomb == "wolf":
        if params.wolf_style == "pairwise":
            shift = _erfc(kappa * params.qq_cut) / params.qq_cut
            return qq2 * (_erfc(kappa * r) / r - shift)
        return qq2 * _erfc(kappa * r) / r
    if params.coulomb == "bare":
        return qq2 / r
    raise ValueError(params.coulomb)


def nlist_radius(system, params):
    """COM-based list radius: the site cutoff, plus the skin, plus twice
    the largest atom-to-COM distance (atoms of a molecule pair can be
    closer than their COMs by up to 2 r_body)."""
    r_body = float(np.max(np.linalg.norm(np.asarray(system.body), axis=-1)))
    return max(params.r_cut, params.qq_cut) + params.nlist_skin + 2.0 * r_body


def rebuild_nlist(com, box, params, r_list, chunk=8):
    """Molecule-level Verlet lists: for every molecule, the indices of the
    nlist_width nearest other molecules, kept only when within `r_list`
    (see nlist_radius; out-of-range and padding slots hold the molecule's
    OWN index, which every pair mask already excludes).

    com (C, M, 3), box (C,) -> (C, M, NB) int32.  Chunked over chains to
    bound the O(M^2) distance matrix.  Exact while no molecule pair
    approaches by more than nlist_skin between rebuilds (rebuilds happen
    every sweep; see RunParams.nlist_skin).
    """
    C, M, _ = com.shape
    nb = params.nlist_width
    self_idx = jnp.arange(M, dtype=jnp.int32)

    def one(com_c, box_c):
        dr = com_c[:, None, :] - com_c[None, :, :]
        dr = dr - box_c * jnp.round(dr / box_c)
        d2 = jnp.sum(dr * dr, axis=-1)
        d2 = d2 + jnp.eye(M, dtype=d2.dtype) * 1e12   # exclude self
        needed = jnp.max(jnp.sum(d2 < r_list * r_list, axis=1))
        neg, idx = jax.lax.top_k(-d2, nb)
        within = (-neg) < r_list * r_list
        lists = jnp.where(within, idx.astype(jnp.int32), self_idx[:, None])
        return lists, needed.astype(jnp.int32)

    from metropolismontecarlo_tpu.utils.chunking import chunked_vmap

    return chunked_vmap(one, chunk, com, box)


def make_sweep_fn(system, params, kvecs, kweights, dtype=jnp.float32,
                  species=None):
    """Build `sweep_body(state, m) -> (state, None)` advancing every chain
    by one move of molecule m.

    species: a System.species_slices entry (name, m0, m1, p, a0) — the
    molecule range this body serves (m must lie in [m0, m1)); None means
    the whole system as one uniform-width block.  Ragged mixtures build
    one body per species block (each with its own static atom count p
    and atom offset a0) and scan them in sequence — no per-molecule
    padding work anywhere.
    """
    M = system.n_mol
    A = system.n_atoms
    A_pad = system.n_atoms_padded
    if species is None:
        if not system.uniform_width:
            raise ValueError("ragged systems need per-species sweep bodies")
        species = ("all", 0, M, system.atoms_per_mol, 0)
    _, m0, m1, P, a0 = species
    off0 = a0 - m0 * P          # atom base of molecule m is off0 + m*P

    body = jnp.asarray(np.asarray(system.body)[:, :P], dtype)   # (M,P,3)
    charges_mp = jnp.asarray(np.asarray(system.charges)[:, :P], dtype)
    charges_pad = np.zeros(A_pad)
    charges_pad[:A] = system.flat(system.charges)
    charges_flat = jnp.asarray(charges_pad, dtype)              # (A_pad,)
    mol_of_atom = jnp.asarray(system.mol_of_atom_padded)        # (A_pad,)
    first_atom_idx = jnp.asarray(system.mol_a0)                 # (M,)

    tid = system.flat(system.type_ids)
    # padded per-atom type ids with pads clamped to 0 (pads are excluded by
    # molecule-id masks before any parameter lookup matters)
    tid_safe = jnp.asarray(np.concatenate([tid, np.zeros(A_pad - A, tid.dtype)]))
    eps_t = jnp.asarray(system.eps_table, dtype)
    sig_t = jnp.asarray(system.sig_table, dtype)

    kv = None if kvecs is None else jnp.asarray(kvecs)
    kw = None if kweights is None else jnp.asarray(kweights, dtype)

    site = params.cutoff_mode == "site"
    use_rot = P > 1 and params.p_translate < 1.0
    use_coul = params.coulomb != "none"
    factor = jnp.asarray(COULOMB_FACTOR, dtype)
    rc2 = jnp.asarray(params.r_cut**2, dtype)
    qrc2 = jnp.asarray(params.qq_cut**2, dtype)
    if params.lj_shift == "linear":
        from metropolismontecarlo_tpu.ops.lj import _shift_coeffs  # noqa: PLC0415

    # ---------------- proposal / finalize (per chain, vmapped) ----------

    def propose_full(com, quat, coords, box, key, dr_max, dphi_max, m, step):
        # reference proposal conventions: translation components uniform in
        # (-dr_max/2, dr_max/2) (`random_translate_vector`,
        # `Ewald/auxillary.jl:94-103`); rotation by a random angle about a
        # random axis (`random_rotate_quaternion`).
        kmove = jax.random.fold_in(key, step)
        k_sel, k_trans, k_rot, k_acc = jax.random.split(kmove, 4)
        com_m = com[m]
        quat_m = quat[m]
        body_m = body[m]
        ra_old = jax.lax.dynamic_slice(coords, (0, off0 + m * P), (3, P)).T
        if use_rot:
            is_trans = jax.random.uniform(k_sel, dtype=dtype) < params.p_translate
        else:
            is_trans = jnp.asarray(True)
        delta = (jax.random.uniform(k_trans, (3,), dtype=dtype) - 0.5) * dr_max
        com_new = wrap(com_m + jnp.where(is_trans, delta, 0.0), box)
        if use_rot:
            quat_rot = random_rotate_quaternion(k_rot, quat_m, dphi_max)
            quat_new = jnp.where(is_trans, quat_m, quat_rot)
            ra_new = com_new[None, :] + rotate_vectors(quat_new, body_m)
        else:
            quat_new = quat_m
            ra_new = com_new[None, :] + rotate_vectors(quat_m, body_m) \
                if P > 1 else com_new[None, :]
        return dict(k_acc=k_acc, com_m=com_m, quat_m=quat_m, ra_old=ra_old,
                    is_trans=is_trans, com_new=com_new, quat_new=quat_new,
                    ra_new=ra_new)

    def finalize(com, quat, coords, box, sfac, energy, temp, pr, d_e, ovr, m):
        """Metropolis + where-select state update (per chain)."""
        if params.coulomb == "ewald":
            q_m = charges_mp[m]
            dsfac = ewald_ops.delta_structure_factor(
                pr["ra_old"][None], pr["ra_new"][None], q_m[None], kv, box
            )[0]
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
            d_recip = ewald_ops.recip_energy_delta(sfac, dsfac, cf)
            d_e = d_e + d_recip
            if params.ewald_surface:
                # dipole/surface delta: E = c |M|^2, c = factor 2pi/(3V);
                # M recomputed from state (O(A), jnp path only) and the
                # moved molecule's dipole swapped old -> new
                com_all = com[jnp.clip(mol_of_atom, 0, M - 1)]  # (A_pad, 3)
                m_tot = ewald_ops.surface_dipole(
                    coords.T, com_all, charges_flat, box)
                mu_old = ewald_ops.surface_dipole(
                    pr["ra_old"], pr["com_m"][None, :], q_m, box)
                mu_new = ewald_ops.surface_dipole(
                    pr["ra_new"], pr["com_new"][None, :], q_m, box)
                m_new = m_tot - mu_old + mu_new
                c_surf = factor * 2.0 * jnp.pi / (3.0 * box**3)
                d_e = d_e + c_surf * (jnp.sum(m_new * m_new)
                                      - jnp.sum(m_tot * m_tot))
        else:
            dsfac = jnp.zeros_like(sfac)

        beta_de = d_e / temp
        u = jax.random.uniform(pr["k_acc"], dtype=dtype)
        accept = ((beta_de < 0.0) | (u < jnp.exp(-beta_de))) & (~ovr)

        com = jax.lax.dynamic_update_slice(
            com, jnp.where(accept, pr["com_new"], pr["com_m"])[None, :], (m, 0))
        quat = jax.lax.dynamic_update_slice(
            quat, jnp.where(accept, pr["quat_new"], pr["quat_m"])[None, :],
            (m, 0))
        coords = jax.lax.dynamic_update_slice(
            coords, jnp.where(accept, pr["ra_new"], pr["ra_old"]).T,
            (0, off0 + m * P))
        sfac = jnp.where(accept, sfac + dsfac, sfac)
        energy = jnp.where(accept, energy + d_e, energy)
        return com, quat, coords, sfac, energy, pr["is_trans"], accept

    # ---------------- jnp pair-energy path (per chain) ------------------

    def pair_energy_rows(ra2p, key_old, key_new, com, coords_t, m, box, kappa):
        """Stacked old/new pair energies: ra2p (2P, 3), coords_t (3, A_pad).
        Returns (d_e_pairs (), overlap ())."""
        dr = min_image(ra2p.T[:, :, None] - coords_t[:, None, :], box)
        d2 = jnp.maximum(jnp.sum(dr * dr, axis=0), jnp.asarray(1e-4, dtype))

        other = ((mol_of_atom != m) & (mol_of_atom >= 0))[None, :]
        if site:
            mask_lj = other & (d2 < rc2)
            mask_qq = mask_lj if params.qq_r_cut is None else other & (d2 < qrc2)
        else:
            keys = com if params.cutoff_mode == "com" \
                else coords_t[:, first_atom_idx].T
            kpts = jnp.stack([key_old, key_new])                # (2, 3)
            d2m = jnp.sum(min_image(kpts[:, None, :] - keys[None], box) ** 2,
                          axis=-1)                              # (2, M)
            halves = jnp.repeat(jnp.arange(2), P)               # (2P,)
            inc = (d2m < rc2)[:, mol_of_atom]                   # (2, A_pad)
            mask_lj = other & inc[halves]
            mask_qq = mask_lj if params.qq_r_cut is None \
                else other & ((d2m < qrc2)[:, mol_of_atom])[halves]

        d2s = jnp.where(mask_lj | mask_qq, d2, jnp.ones((), dtype))
        tm = tid_mp_all[m]                                      # (P,)
        eps_pa = eps_t[tm][:, tid_safe]                         # (P, A_pad)
        sig2_pa = (sig_t**2)[tm][:, tid_safe]
        eps2 = jnp.concatenate([eps_pa, eps_pa], axis=0)
        sig2 = jnp.concatenate([sig2_pa, sig2_pa], axis=0)

        s2 = sig2 / d2s
        s6 = s2 * s2 * s2
        pot = 4.0 * eps2 * (s6 * s6 - s6)
        if params.lj_shift == "linear":
            sig_pa = jnp.sqrt(sig2)
            lam1, lam2 = _shift_coeffs(params.r_cut / sig_pa)
            pot = pot + eps2 * (lam1 + lam2 * jnp.sqrt(d2s) / sig_pa)
        e_lj = jnp.sum(jnp.where(mask_lj, pot, 0.0), axis=-1)   # (2P,)

        d_e = jnp.sum(e_lj[P:]) - jnp.sum(e_lj[:P])
        overlap = jnp.zeros((), bool)
        if use_coul:
            qq_pa = charges_mp[m][:, None] * charges_flat[None, :]
            qq2 = jnp.concatenate([qq_pa, qq_pa], axis=0)
            r = jnp.sqrt(d2s)
            cpair = _coulomb_pair(qq2, r, kappa, params)
            e_coul = factor * jnp.sum(jnp.where(mask_qq, cpair, 0.0), axis=-1)
            d_e = d_e + jnp.sum(e_coul[P:]) - jnp.sum(e_coul[:P])
            bad = (d2 < params.d2_overlap) & (qq2 < 0.0) & mask_qq
            overlap = jnp.any(bad[P:])
        return d_e, overlap

    use_nlist = params.nlist_width > 0
    if use_nlist and not site:
        raise NotImplementedError("neighbor lists require site cutoff")
    tid_mp_all = jnp.asarray(np.asarray(system.type_ids)[:, :P])
    # ragged-aware neighbor gather tables: neighbor molecule j owns
    # mol_p[j] atoms starting at mol_a0[j]; gather width is the widest
    # species, with out-of-molecule slots masked (clamped to column 0)
    nl_p = system.atoms_per_mol
    mol_p_j = jnp.asarray(system.mol_p)
    mol_a0_j = jnp.asarray(system.mol_a0)

    def pair_energy_nlist(ra2p, nbr_row, coords_t, m, box, kappa):
        """Pair energies against gathered neighbor atoms only.
        ra2p (2P, 3); nbr_row (NB,) neighbor molecule indices (self-padded).
        """
        slots = jnp.arange(nl_p, dtype=nbr_row.dtype)
        valid = (slots[None, :] < mol_p_j[nbr_row][:, None]).reshape(-1)
        atom_idx = (mol_a0_j[nbr_row][:, None] + slots[None, :]).reshape(-1)
        atom_idx = jnp.where(valid, atom_idx, 0)       # clamped; masked out
        g = coords_t[:, atom_idx]                      # (3, NB*nl_p)
        mol_g = jnp.repeat(nbr_row, nl_p)              # (NB*nl_p,)
        dr = min_image(ra2p.T[:, :, None] - g[:, None, :], box)
        d2 = jnp.maximum(jnp.sum(dr * dr, axis=0), jnp.asarray(1e-4, dtype))
        other = ((mol_g != m) & valid)[None, :]
        mask_lj = other & (d2 < rc2)
        mask_qq = mask_lj if params.qq_r_cut is None else other & (d2 < qrc2)
        d2s = jnp.where(mask_lj | mask_qq, d2, jnp.ones((), dtype))

        tm = tid_mp_all[m]
        tid_g = tid_safe[atom_idx]
        eps_pa = jnp.take(eps_t[tm], tid_g, axis=1)    # (P, NB*P)
        sig2_pa = jnp.take((sig_t**2)[tm], tid_g, axis=1)
        eps2 = jnp.concatenate([eps_pa, eps_pa], axis=0)
        sig2 = jnp.concatenate([sig2_pa, sig2_pa], axis=0)
        s2 = sig2 / d2s
        s6 = s2 * s2 * s2
        pot = 4.0 * eps2 * (s6 * s6 - s6)
        if params.lj_shift == "linear":
            sig_g = jnp.sqrt(sig2)
            lam1, lam2 = _shift_coeffs(params.r_cut / sig_g)
            pot = pot + eps2 * (lam1 + lam2 * jnp.sqrt(d2s) / sig_g)
        e_lj = jnp.sum(jnp.where(mask_lj, pot, 0.0), axis=-1)
        d_e = jnp.sum(e_lj[P:]) - jnp.sum(e_lj[:P])
        overlap = jnp.zeros((), bool)
        if use_coul:
            q_g = charges_flat[atom_idx]
            qq_pa = charges_mp[m][:, None] * q_g[None, :]
            qq2 = jnp.concatenate([qq_pa, qq_pa], axis=0)
            r = jnp.sqrt(d2s)
            cpair = _coulomb_pair(qq2, r, kappa, params)
            e_coul = factor * jnp.sum(jnp.where(mask_qq, cpair, 0.0), axis=-1)
            d_e = d_e + jnp.sum(e_coul[P:]) - jnp.sum(e_coul[:P])
            bad = (d2 < params.d2_overlap) & (qq2 < 0.0) & mask_qq
            overlap = jnp.any(bad[P:])
        return d_e, overlap

    def move_jnp(com, quat, coords, box, sfac, energy, key, dr_max,
                 dphi_max, temp, nbr, m, step):
        kappa = jnp.asarray(params.kappa_L, dtype) / box
        pr = propose_full(com, quat, coords, box, key, dr_max, dphi_max,
                          m, step)
        key_old = pr["ra_old"][0] if params.cutoff_mode == "first" \
            else pr["com_m"]
        key_new = pr["ra_new"][0] if params.cutoff_mode == "first" \
            else pr["com_new"]
        ra2p = jnp.concatenate([pr["ra_old"], pr["ra_new"]], axis=0)
        if use_nlist:
            d_e, ovr = pair_energy_nlist(ra2p, nbr[m], coords, m, box, kappa)
        else:
            d_e, ovr = pair_energy_rows(ra2p, key_old, key_new, com, coords,
                                        m, box, kappa)
        return finalize(com, quat, coords, box, sfac, energy, temp, pr,
                        d_e, ovr, m)

    # ---------------- sweep bodies --------------------------------------

    def _update_counters(state, is_trans, accept):
        it = is_trans.astype(jnp.int32)
        ac = accept.astype(jnp.int32)
        att = state.att.at[:, 0].add(it).at[:, 1].add(1 - it)
        acc = state.acc.at[:, 0].add(it * ac).at[:, 1].add((1 - it) * ac)
        return att, acc

    vmove = jax.vmap(
        move_jnp,
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None, None),
    )

    def sweep_body(state, m):
        com, quat, coords, sfac, energy, is_trans, accept = vmove(
            state.com, state.quat, state.coords, state.box, state.sfac,
            state.energy, state.key, state.dr_max, state.dphi_max,
            state.temp, state.nbr, m, state.step)
        att, acc = _update_counters(state, is_trans, accept)
        return state._replace(
            com=com, quat=quat, coords=coords, sfac=sfac, energy=energy,
            step=state.step + 1, att=att, acc=acc), None

    return sweep_body
