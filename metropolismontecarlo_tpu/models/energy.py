"""Full-system energy evaluation with component breakdown.

The data-parallel analogue of the reference's six `potential(...)` overloads
(`Ewald/energy.jl:343-1032`): one function, dense masked pair grids, a
dict of components.  Used for initialization, NIST golden validation,
block-end drift checks, and NPT volume moves.  Per-move delta energies
live in `mc.moves` (they share the same ops, guaranteeing consistency).

Single-chain signature; batch over chains with `jax.vmap`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.ops import coulomb as coulomb_ops
from metropolismontecarlo_tpu.ops import ewald as ewald_ops
from metropolismontecarlo_tpu.ops import lj as lj_ops
from metropolismontecarlo_tpu.ops import tail as tail_ops
from metropolismontecarlo_tpu.ops import wolf as wolf_ops
from metropolismontecarlo_tpu.ops.pairs import full_pair_mask, pair_dist2


def _intra_terms(system, coords, kappa, box, dtype):
    """(E_intra, W_intra_kappa) summed over species blocks: ragged systems
    evaluate each species' (count, p, 3) slice separately (static slices,
    no per-molecule padding work)."""
    e = w = jnp.zeros((), dtype)
    for _, m0, m1, p, a0 in system.species_slices:
        if p < 2:
            continue
        c = coords[a0:a0 + (m1 - m0) * p].reshape(m1 - m0, p, 3)
        q = jnp.asarray(np.asarray(system.charges)[m0:m1, :p], dtype)
        e = e + ewald_ops.ewald_intra(c, q, kappa, box)
        w = w + ewald_ops.ewald_intra_kappa(c, q, kappa, box)
    return e, w


def energy_breakdown(system, params, coords, com, box, kvecs=None, kweights=None):
    """Total potential energy of one configuration, by component.

    coords (A, 3), com (M, 3), box scalar (all jnp, any float dtype).
    Returns a dict of scalars:
      disp, lrc, coul_real, coul_fourier, coul_self, coul_intra, total,
      w (molecular virial sum r_ij.f_ij), and sfac (K, 2) when Ewald.

    Systems above ~4096 atoms use a row-tiled pair sum (O(B*A) memory)
    instead of the dense (A, A) grid.
    """
    if system.n_atoms > 4096:
        return _energy_breakdown_tiled(system, params, coords, com, box,
                                       kvecs, kweights)
    M, P = system.n_mol, system.atoms_per_mol
    dtype = coords.dtype
    tid = system.flat(system.type_ids)
    charges = jnp.asarray(system.flat(system.charges), dtype)
    # (A, A) pair tables are expanded in NUMPY at trace time and embedded
    # as constants: a traced (A, A) table gather inside the chunked-vmap
    # scan is NOT hoisted by XLA and is paid again at every scan step
    tid_np = np.asarray(tid)
    eps_t = jnp.asarray(system.eps_table, dtype)
    sig_t = jnp.asarray(system.sig_table, dtype)
    eps_pair = jnp.asarray(
        np.asarray(system.eps_table)[tid_np[:, None], tid_np[None, :]], dtype)
    sig_pair = jnp.asarray(
        np.asarray(system.sig_table)[tid_np[:, None], tid_np[None, :]], dtype)

    mol_id = jnp.asarray(system.mol_of_atom_padded[: system.n_atoms])
    key = com if params.cutoff_mode != "first" \
        else coords[jnp.asarray(system.mol_a0)]

    d2, dr_ab = pair_dist2(coords, coords, box)
    # molecular (COM) displacement grid for the virial, in the image
    # CONSISTENT with each atom pair: r_ij = r_ab - (d_a - d_b) with d the
    # rigid atom-from-COM offsets.  Min-imaging the COM grid independently
    # picks the wrong image for boundary pairs when r_cut approaches L/2
    # (e.g. the 20 A NIST boxes), which corrupts the virial projection.
    delta = coords - com[mol_id]
    delta = delta - box * jnp.round(delta / box)
    dr_ij = dr_ab - delta[:, None, :] + delta[None, :, :]

    site = params.cutoff_mode == "site"
    mask_lj = full_pair_mask(coords, key, M, box, params.r_cut,
                             "site" if site else params.cutoff_mode,
                             mol_id=mol_id)
    pot, w = lj_ops.lj_masked_sum(
        d2, dr_ab, dr_ij, mask_lj, eps_pair, sig_pair, params.r_cut,
        params.lj_shift, site_cutoff=False,  # mask already applies site cutoff
    )
    out = {}
    out["disp"] = 0.5 * pot
    w_total = 0.5 * w

    counts = jnp.asarray(system.type_counts, dtype)
    vol = box**3
    w_lrc = w_lrc_ref = jnp.zeros((), dtype)
    if params.use_lrc and params.lj_shift == "none":
        out["lrc"] = tail_ops.lrc_energy(counts, eps_t, sig_t, params.r_cut, vol)
        # the sampled model adds U_lrc = C/V to the energy, so its exact
        # dU/dV contribution is -U_lrc/V, i.e. w_lrc = 3 U_lrc; the
        # textbook virial-integral form (reference convention) differs
        # and is kept for w_ref
        w_lrc = 3.0 * out["lrc"]
        w_lrc_ref = 3.0 * vol * tail_ops.lrc_pressure(
            counts, eps_t, sig_t, params.r_cut, vol
        )
    else:
        out["lrc"] = jnp.zeros((), dtype)

    e_real = e_four = e_self = e_intra = jnp.zeros((), dtype)
    w_ref = w_coul = jnp.zeros((), dtype)
    sfac = jnp.zeros((1, 2), dtype)
    if params.coulomb != "none":
        kappa = params.kappa_L / box
        qq = charges[:, None] * charges[None, :]
        if params.qq_r_cut is None and params.cutoff_mode != "site":
            mask_qq = mask_lj
        else:
            mask_qq = full_pair_mask(coords, key, M, box, params.qq_cut,
                                     params.cutoff_mode, mol_id=mol_id)
        dot = jnp.sum(dr_ij * dr_ab, axis=-1)  # r_ij_com . r_ab per pair
        if params.coulomb == "ewald":
            e_real = 0.5 * ewald_ops.real_space_sum(d2, qq, mask_qq, kappa)
            cf = ewald_ops.cfac_coeffs(kvecs, kweights, kappa, box, dtype)
            sfac = ewald_ops.structure_factor(coords, charges, kvecs, box)
            e_four = ewald_ops.recip_energy(sfac, cf)
            e_self = ewald_ops.ewald_self(charges, kappa)
            e_intra, w_intra = _intra_terms(system, coords, kappa, box, dtype)
            # EXACT molecular virial (closed form; see ops.ewald): the
            # self term's kappa derivative equals E_self itself
            w_coul = (
                0.5 * ewald_ops.real_space_virial(d2, qq, dot, mask_qq,
                                                  kappa, "ewald")
                + ewald_ops.recip_virial(sfac, cf, coords, com[mol_id],
                                         charges, kvecs, box)
                + e_self
                + w_intra
            )
            if params.ewald_surface:
                e_surf = ewald_ops.surface_term(coords, com[mol_id],
                                                charges, box)
                e_four = e_four + e_surf
                w_coul = w_coul + 3.0 * e_surf  # U ~ 1/V, like the LRC
        elif params.coulomb == "wolf":
            shifted = params.wolf_style == "pairwise"
            e_real = 0.5 * wolf_ops.wolf_pair_sum(
                d2, qq, mask_qq, kappa, params.qq_cut, shifted=shifted
            )
            e_self = wolf_ops.wolf_self(charges, kappa, params.qq_cut)
            # wolf_pair_sum keeps only SITE pairs inside qq_cut even under
            # molecular cutoff modes (the shifted form must vanish at the
            # cutoff); the exact-dU/dV virial must sum the SAME pair set
            # (keep == mask_qq in site mode)
            keep_w = mask_qq & (d2 < params.qq_cut ** 2)
            w_coul = (
                0.5 * ewald_ops.real_space_virial(
                    d2, qq, dot, keep_w, kappa,
                    "wolf" if shifted else "ewald", qq_cut=params.qq_cut)
                + wolf_ops.wolf_self_kappa(charges, kappa, params.qq_cut)
            )
            if not shifted:  # reference convention's global constant
                e_self = e_self + wolf_ops.wolf_ref_const(
                    charges, kappa, params.qq_cut)
                w_coul = w_coul + wolf_ops.wolf_ref_const_kappa(
                    charges, kappa, params.qq_cut)
        elif params.coulomb == "bare":
            e_real = 0.5 * coulomb_ops.bare_pair_sum(d2, qq, mask_qq)
            w_coul = 0.5 * ewald_ops.real_space_virial(
                d2, qq, dot, mask_qq, kappa, "bare")
        else:
            raise ValueError(f"unknown coulomb style {params.coulomb!r}")
        # reference convention kept for number-for-number comparison:
        # pair-virial of 1/r equals its energy, E_coul/3 per component
        # (`Ewald/energy.jl:1004-1021`)
        w_ref = e_real + e_four + e_self + e_intra

    out["coul_real"] = e_real
    out["coul_fourier"] = e_four
    out["coul_self"] = e_self
    out["coul_intra"] = e_intra
    out["total"] = (
        out["disp"] + out["lrc"] + e_real + e_four + e_self + e_intra
    )
    # "w" is the EXACT molecular virial: P = rho T + w/(3V) matches the
    # finite-difference pressure (MonteCarlo.pressure_fd) to FD error.
    # "w_ref" keeps the reference's E/3 coulomb + textbook-LRC convention.
    out["w"] = w_total + w_lrc + w_coul
    out["w_ref"] = w_total + w_lrc_ref + w_ref
    out["sfac"] = sfac
    return out


def _energy_breakdown_tiled(system, params, coords, com, box, kvecs,
                            kweights, row_block=256, row_shard=None):
    """Row-tiled full energy for large systems (site cutoff only).

    Scans row blocks of B atoms against all A atoms: peak pair-grid
    memory O(B*A) instead of O(A^2).  Per-pair LJ parameters come from a
    (B, T) gather x (T, A) one-hot matmul, never an (A, A) table.

    row_shard=(axis_name, n_shards): tensor-parallel mode for use INSIDE
    shard_map — the row-block scan, the S(k) structure factor, and the
    reciprocal-virial contraction (the O(A^2) and O(K*A) work) are split
    over the named mesh axis and psum-reduced; the O(A)
    assembly terms are computed replicated.  Every device returns the
    identical full breakdown.  This is the SURVEY section-2.2 "shard the
    pair tiles / (K, A) recip matmul" path for systems far beyond 10^4
    atoms; the per-move sweep stays chain-local by design (a per-move
    psum would be bound by interconnect latency).
    """
    if params.cutoff_mode != "site":
        raise NotImplementedError("tiled recompute supports site cutoff")
    M, P, A = system.n_mol, system.atoms_per_mol, system.n_atoms
    dtype = coords.dtype
    B = row_block
    if row_shard is not None:
        shard_axis, n_sh = row_shard
        A_r = -(-A // (B * n_sh)) * (B * n_sh)  # same block count per shard
    else:
        shard_axis, n_sh = None, 1
        A_r = -(-A // B) * B  # rows padded to a block multiple

    tid = system.flat(system.type_ids)
    tid_pad = np.zeros(A_r, tid.dtype)
    tid_pad[:A] = tid
    tid_rows = jnp.asarray(tid_pad)
    mol_np = np.full(A_r, -1, np.int32)
    mol_np[:A] = system.atom_mol_slot[0]
    mol_rows = jnp.asarray(mol_np)
    mol_cols = jnp.asarray(mol_np[:A])
    q_np = np.zeros(A_r)
    q_np[:A] = system.flat(system.charges)
    q_rows = jnp.asarray(q_np, dtype)
    q_cols = q_rows[:A]

    eps_t = jnp.asarray(system.eps_table, dtype)
    sig_t = jnp.asarray(system.sig_table, dtype)
    n_types = system.eps_table.shape[0]
    onehot_cols = jax.nn.one_hot(jnp.asarray(tid), n_types, dtype=dtype).T

    coords_rows = jnp.zeros((A_r, 3), dtype).at[:A].set(coords)
    com_of_col = com[jnp.clip(mol_cols, 0, M - 1)]              # (A, 3)
    # rigid atom-from-COM offsets for the consistent-image virial grids
    delta_col = coords - com_of_col
    delta_col = delta_col - box * jnp.round(delta_col / box)    # (A, 3)
    delta_row = jnp.zeros((A_r, 3), dtype).at[:A].set(delta_col)

    rc2 = jnp.asarray(params.r_cut**2, dtype)
    qrc2 = jnp.asarray(params.qq_cut**2, dtype)
    kappa = jnp.asarray(params.kappa_L, dtype) / box
    use_coul = params.coulomb != "none"

    def tile(carry, i):
        pot_a, w_a, er_a, wc_a = carry
        rows = jax.lax.dynamic_slice(coords_rows, (i * B, 0), (B, 3))
        mrow = jax.lax.dynamic_slice_in_dim(mol_rows, i * B, B)
        trow = jax.lax.dynamic_slice_in_dim(tid_rows, i * B, B)
        qrow = jax.lax.dynamic_slice_in_dim(q_rows, i * B, B)
        drow = jax.lax.dynamic_slice(delta_row, (i * B, 0), (B, 3))

        dr = rows[:, None, :] - coords[None, :, :]
        dr = dr - box * jnp.round(dr / box)
        d2 = jnp.maximum(jnp.sum(dr * dr, -1), jnp.asarray(1e-4, dtype))
        valid = (mrow[:, None] >= 0) & (mrow[:, None] != mol_cols[None, :])
        mask_lj = valid & (d2 < rc2)
        mask_qq = valid & (d2 < qrc2)
        d2s = jnp.where(mask_lj | mask_qq, d2, jnp.ones((), dtype))

        hi = jax.lax.Precision.HIGHEST  # bf16 would corrupt eps/sig
        eps_pa = jnp.matmul(eps_t[trow], onehot_cols, precision=hi)  # (B, A)
        sig2_pa = jnp.matmul((sig_t**2)[trow], onehot_cols, precision=hi)
        s2 = sig2_pa / d2s
        s6 = s2 * s2 * s2
        pair_pot = 4.0 * eps_pa * (s6 * s6 - s6)
        if params.lj_shift == "linear":
            from metropolismontecarlo_tpu.ops.lj import _shift_coeffs
            sig_pa = jnp.sqrt(sig2_pa)
            lam1, lam2 = _shift_coeffs(params.r_cut / sig_pa)
            pair_pot = pair_pot + eps_pa * (lam1 + lam2 * jnp.sqrt(d2s) / sig_pa)
        potm = jnp.where(mask_lj, pair_pot, 0.0)
        pot_a = pot_a + jnp.sum(potm)

        # molecular virial: (r_ij_com . r_ab / r_ab^2) * 24 eps (2 s12 - s6)
        # with the pair-consistent COM image r_ij = r_ab - (d_a - d_b)
        mol_dr = dr - drow[:, None, :] + delta_col[None, :, :]
        proj = jnp.sum(mol_dr * dr, -1) / d2s
        wv = jnp.where(mask_lj, 24.0 * eps_pa * (2 * s6 * s6 - s6) * proj, 0.0)
        w_a = w_a + jnp.sum(wv)

        if use_coul:
            qq = qrow[:, None] * q_cols[None, :]
            r = jnp.sqrt(d2s)
            if params.coulomb == "ewald" or (
                    params.coulomb == "wolf"
                    and params.wolf_style != "pairwise"):
                cp = qq * jax.scipy.special.erfc(kappa * r) / r
            elif params.coulomb == "wolf":
                sh = jax.scipy.special.erfc(kappa * params.qq_cut) / params.qq_cut
                cp = qq * (jax.scipy.special.erfc(kappa * r) / r - sh)
            else:
                cp = qq / r
            er_a = er_a + jnp.sum(jnp.where(mask_qq, cp, 0.0))
            # exact molecular-virial pair terms (see ops.ewald.
            # real_space_virial; factor applied after the scan)
            dot = jnp.sum(mol_dr * dr, -1)
            c2 = ewald_ops._TWO_OVER_RTPI
            if params.coulomb == "bare":
                wv = qq * dot / (d2s * r)
            else:
                gauss = jnp.exp(-(kappa * kappa) * d2s)
                wv = qq * (dot * (jax.scipy.special.erfc(kappa * r)
                                  / (d2s * r) + kappa * c2 * gauss / d2s)
                           - kappa * c2 * gauss)
                if params.coulomb == "wolf" \
                        and params.wolf_style == "pairwise":
                    wv = wv + qq * kappa * c2 \
                        * jnp.exp(-(kappa * params.qq_cut) ** 2)
            wc_a = wc_a + jnp.sum(jnp.where(mask_qq, wv, 0.0))
        return (pot_a, w_a, er_a, wc_a), None

    zero = jnp.zeros((), dtype)
    if shard_axis is not None:
        nblk_loc = A_r // B // n_sh
        blocks = (jnp.arange(nblk_loc)
                  + jax.lax.axis_index(shard_axis) * nblk_loc)
    else:
        blocks = jnp.arange(A_r // B)
    (pot, w, e_real_raw, w_coul_raw), _ = jax.lax.scan(
        tile, (zero, zero, zero, zero), blocks)
    if shard_axis is not None:
        pot, w, e_real_raw, w_coul_raw = jax.lax.psum(
            (pot, w, e_real_raw, w_coul_raw), shard_axis)

    out = {}
    out["disp"] = 0.5 * pot
    w_total = 0.5 * w
    counts = jnp.asarray(system.type_counts, dtype)
    vol = box**3
    w_lrc = w_lrc_ref = jnp.zeros((), dtype)
    if params.use_lrc and params.lj_shift == "none":
        out["lrc"] = tail_ops.lrc_energy(counts, eps_t, sig_t, params.r_cut, vol)
        w_lrc = 3.0 * out["lrc"]  # exact dU/dV of the sampled model
        w_lrc_ref = 3.0 * vol * tail_ops.lrc_pressure(
            counts, eps_t, sig_t, params.r_cut, vol)
    else:
        out["lrc"] = jnp.zeros((), dtype)

    from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR
    e_real = e_four = e_self = e_intra = jnp.zeros((), dtype)
    w_ref = w_coul = jnp.zeros((), dtype)
    sfac = jnp.zeros((1, 2), dtype)
    if use_coul:
        charges = q_cols
        e_real = 0.5 * COULOMB_FACTOR * e_real_raw
        w_coul = 0.5 * COULOMB_FACTOR * w_coul_raw
        if params.coulomb == "ewald":
            cf = ewald_ops.cfac_coeffs(kvecs, kweights, kappa, box, dtype)
            if shard_axis is not None:
                # shard the O(K*A) contractions over local atom slices
                # (padded rows carry q=0, coords=com=0: zero contribution)
                A_loc = A_r // n_sh
                a0 = jax.lax.axis_index(shard_axis) * A_loc
                z0 = jnp.zeros((), a0.dtype)
                c_sl = jax.lax.dynamic_slice(coords_rows, (a0, z0),
                                             (A_loc, 3))
                q_sl = jax.lax.dynamic_slice_in_dim(q_rows, a0, A_loc)
                com_rows = jnp.zeros((A_r, 3), dtype).at[:A].set(com_of_col)
                m_sl = jax.lax.dynamic_slice(com_rows, (a0, z0), (A_loc, 3))
                sfac = jax.lax.psum(
                    ewald_ops.structure_factor(c_sl, q_sl, kvecs, box),
                    shard_axis)
                e_four = ewald_ops.recip_energy(sfac, cf)
                # recip_virial = e_recip (replicated, from the full S(k))
                # minus the sharded T-contraction: psum only the latter
                w_recip = e_four + jax.lax.psum(
                    ewald_ops.recip_virial(sfac, cf, c_sl, m_sl, q_sl,
                                           kvecs, box) - e_four, shard_axis)
            else:
                sfac = ewald_ops.structure_factor(coords, charges, kvecs, box)
                w_recip = ewald_ops.recip_virial(
                    sfac, cf, coords, com_of_col, charges, kvecs, box)
                e_four = ewald_ops.recip_energy(sfac, cf)
            e_self = ewald_ops.ewald_self(charges, kappa)
            e_intra, w_intra = _intra_terms(system, coords, kappa, box, dtype)
            w_coul = w_coul + w_recip + e_self + w_intra
            if params.ewald_surface:
                e_surf = ewald_ops.surface_term(
                    coords, com[jnp.clip(mol_cols, 0, M - 1)], charges, box)
                e_four = e_four + e_surf
                w_coul = w_coul + 3.0 * e_surf
        elif params.coulomb == "wolf":
            e_self = wolf_ops.wolf_self(charges, kappa, params.qq_cut)
            w_coul = w_coul + wolf_ops.wolf_self_kappa(
                charges, kappa, params.qq_cut)
            if params.wolf_style != "pairwise":
                e_self = e_self + wolf_ops.wolf_ref_const(
                    charges, kappa, params.qq_cut)
                w_coul = w_coul + wolf_ops.wolf_ref_const_kappa(
                    charges, kappa, params.qq_cut)
        w_ref = e_real + e_four + e_self + e_intra

    out["coul_real"] = e_real
    out["coul_fourier"] = e_four
    out["coul_self"] = e_self
    out["coul_intra"] = e_intra
    out["total"] = out["disp"] + out["lrc"] + e_real + e_four + e_self + e_intra
    out["w"] = w_total + w_lrc + w_coul
    out["w_ref"] = w_total + w_lrc_ref + w_ref
    out["sfac"] = sfac
    return out


@functools.partial(jax.jit, static_argnums=(0, 1))
def energy_breakdown_jit(system, params, coords, com, box, kvecs=None,
                         kweights=None):
    """Jitted energy_breakdown (system/params static by identity)."""
    return energy_breakdown(system, params, coords, com, box, kvecs, kweights)


def pressure(params, n_mol, volume, w):
    """P/kB = rho T + w/(3V)  (LRC folded into w by energy_breakdown).
    Reference: `Pressure` (`Ewald/auxillary.jl:116-123`)."""
    rho = n_mol / volume
    return rho * params.temperature + w / (3.0 * volume)
