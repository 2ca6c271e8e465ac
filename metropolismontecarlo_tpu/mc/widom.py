"""Widom test-particle insertion: the excess chemical potential.

    mu_ex = -kT ln < exp(-beta dU_test) >_NVT        (Widom 1963;
                                                      Frenkel & Smit ch. 7)

where dU_test is the energy of inserting one ghost molecule at a uniform
random position (and orientation, for rigid bodies) into a sampled
configuration.  The reference has no free-energy machinery; this is a
beyond-parity capability, and a natural data-parallel one: each insertion is a
dense masked (P, A) pair-energy row — exactly the shape of a move's
delta-energy evaluation — so a sample batches n_ins ghost molecules per
chain as one vectorized evaluation, chunk-scanned over chains.

dU is EXACTLY consistent with the sampled model (models/energy.py per
coulomb style and cutoff mode): LJ pairs (+ optional linear shift), the
LJ tail-correction increment U_lrc(N+1) - U_lrc(N), and per style
  * ewald: real-space erfc pairs + reciprocal-space delta via the
    carried structure factors (O(P K), the same RecipMove trick the
    moves use — reference `Ewald/ewalds.jl:718-826`), + the ghost
    molecule's self and intramolecular terms (+ surface-dipole delta
    when enabled);
  * wolf: pairwise(-shifted) erfc pairs + the ghost's self/background
    term (+ the reference convention's total-charge-square constant
    increment);
  * bare: 1/r pairs.

The sampled model's hard-overlap veto (opposite-sign charges closer
than sqrt(d2_overlap), `Ewald/ewalds.jl:359-361`) acts as a hard core:
vetoed insertions contribute exp(-beta dU) = 0, consistent with the
configuration space the MC chain actually samples.

`make_pose_eval` exposes the single-pose machinery (pair terms with an
activity mask and a molecule exclusion, pose structure factors, and the
per-molecule self/intra constants) for reuse by the grand-canonical
molecular app (`mc/gcmc_mol.py`), whose insertion/deletion energies are
by construction the same model as Widom's ghosts.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.ops import ewald as ewald_ops
from metropolismontecarlo_tpu.ops import tail as tail_ops
from metropolismontecarlo_tpu.ops import wolf as wolf_ops
from metropolismontecarlo_tpu.ops.pbc import min_image
from metropolismontecarlo_tpu.ops.quaternions import (
    random_quaternion,
    rotate_vectors,
)
from metropolismontecarlo_tpu.utils.chunking import chunked_vmap
from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR


def mu_excess(boltzmann_mean, temperature):
    """mu_ex = -kT ln <exp(-beta dU)> (energy units of the run, e.g. K)."""
    return -temperature * jnp.log(boltzmann_mean)


def make_pose_eval(system, params, kvecs, kweights, dtype=jnp.float32,
                   species=0):
    """Single-pose energy machinery for one species' rigid molecule.

    Returns a namespace of closures shared by the Widom sampler and the
    grand-canonical molecular app:

      pose_atoms(com_t (3,), quat_t (4,)) -> (P, 3) lab-frame atoms;
      pair_energy(ra (P, 3), coords_t (3, A_pad), com (M, 3), box,
                  atom_ok (A_pad,) bool, excl int)
          -> (e_pair, overlap): LJ + style pair terms of the pose
          against every atom with atom_ok set whose molecule != excl
          (excl = -1 for "no exclusion", e.g. a ghost);
      pose_sfac(ra, box) -> (K, 2) structure-factor contribution of the
          pose's charges (ewald style; None otherwise);
      self_intra(box) -> per-molecule position-independent constant
          (ewald: self + intramolecular; wolf: self/background; else 0);
      wolf_const_coeff(box) -> the reference-Wolf global-constant
          coefficient c with E_const = c * Q_tot^2 (0 unless style is
          wolf/"ref");
      lrc_delta(box) -> U_lrc(N+1) - U_lrc(N) (0 when LRC is off);
      plus fields P, q_t, q_t_tot, q_sys_tot, body_t.

    All terms match models/energy.py exactly per coulomb style and
    cutoff mode (the Widom docstring's consistency contract).
    """
    _, m0, m1, P, a0 = system.species_slices[species]
    A, A_pad, M = system.n_atoms, system.n_atoms_padded, system.n_mol
    body_np = np.asarray(system.body)[m0, :P]
    body_t = jnp.asarray(body_np, dtype)                          # (P, 3)
    q_t_np = np.asarray(system.charges)[m0, :P]
    q_t = jnp.asarray(q_t_np, dtype)                              # (P,)
    tm = np.asarray(system.type_ids)[m0, :P]

    # static (P, A_pad) parameter rows, expanded in NumPy at trace time
    # (no traced table gathers in the hot loop; models/energy.py)
    tid = np.asarray(system.flat(system.type_ids))
    tid_safe = np.concatenate([tid, np.zeros(A_pad - A, tid.dtype)])
    eps_np = np.asarray(system.eps_table)[tm[:, None], tid_safe[None, :]]
    sig_np = np.asarray(system.sig_table)[tm[:, None], tid_safe[None, :]]
    eps_pa = jnp.asarray(eps_np, dtype)
    sig2_pa = jnp.asarray(sig_np**2, dtype)
    charges_pad = np.zeros(A_pad)
    charges_pad[:A] = system.flat(system.charges)
    charges_flat = jnp.asarray(charges_pad, dtype)
    mol_of_atom = jnp.asarray(system.mol_of_atom_padded)          # (A_pad,)
    mol_a0 = jnp.asarray(system.mol_a0)
    real = mol_of_atom >= 0

    site = params.cutoff_mode == "site"
    use_coul = params.coulomb != "none"
    factor = jnp.asarray(COULOMB_FACTOR, dtype)
    rc2 = jnp.asarray(params.r_cut**2, dtype)
    qrc2 = jnp.asarray(params.qq_cut**2, dtype)
    if params.lj_shift == "linear":
        from metropolismontecarlo_tpu.ops.lj import _shift_coeffs
        with np.errstate(divide="ignore", invalid="ignore"):
            l1, l2 = _shift_coeffs(params.r_cut / sig_np)
            lam1_pa = jnp.asarray(np.where(eps_np > 0.0, l1, 0.0), dtype)
            lam2_pa = jnp.asarray(
                np.where(eps_np > 0.0, l2 / np.where(sig_np > 0.0, sig_np, 1.0), 0.0),
                dtype)

    # LRC increment: static type-count vectors, runtime 1/V
    counts_np = np.asarray(system.type_counts, np.float64)
    counts_plus_np = counts_np.copy()
    for t in tm:
        counts_plus_np[t] += 1.0
    counts = jnp.asarray(counts_np, dtype)
    counts_plus = jnp.asarray(counts_plus_np, dtype)
    eps_tab = jnp.asarray(system.eps_table, dtype)
    sig_tab = jnp.asarray(system.sig_table, dtype)
    use_lrc = params.use_lrc and params.lj_shift == "none"

    q_sys_tot = float(np.sum(np.asarray(system.flat(system.charges))))
    q_t_tot = float(np.sum(q_t_np))
    kv = None if kvecs is None else jnp.asarray(kvecs)
    kw = None if kweights is None else jnp.asarray(kweights, dtype)

    def pose_atoms(com_t, quat_t):
        if P > 1:
            return com_t[None, :] + rotate_vectors(quat_t, body_t)  # (P, 3)
        return com_t[None, :]

    def pair_energy(com_t, ra, coords_t, com, box, atom_ok, excl):
        """Pose pair terms (LJ + style pair sums) vs masked atoms.
        com_t (3,) is the pose origin (the molecule COM — the cutoff key
        in com/first modes), ra (P, 3) its lab-frame atoms."""
        dr = min_image(ra.T[:, :, None] - coords_t[:, None, :], box)
        d2 = jnp.maximum(jnp.sum(dr * dr, axis=0),
                         jnp.asarray(1e-4, dtype))                # (P, A_pad)
        base = atom_ok & (mol_of_atom != excl)
        if site:
            mask_lj = base[None, :] & (d2 < rc2)
            mask_qq = base[None, :] & (d2 < qrc2)
        else:
            keys = com if params.cutoff_mode == "com" \
                else coords_t[:, mol_a0].T                        # (M, 3)
            d2m = jnp.sum(min_image(com_t[None, :] - keys, box) ** 2,
                          axis=-1)                                # (M,)
            safe = jnp.clip(mol_of_atom, 0, M - 1)
            mask_lj = base & (d2m < rc2)[safe]
            mask_qq = mask_lj if params.qq_r_cut is None \
                else base & (d2m < qrc2)[safe]
            mask_lj, mask_qq = mask_lj[None, :], mask_qq[None, :]

        d2s = jnp.where(mask_lj | mask_qq, d2, jnp.ones((), dtype))
        s2 = sig2_pa / d2s
        s6 = s2 * s2 * s2
        pot = 4.0 * eps_pa * (s6 * s6 - s6)
        if params.lj_shift == "linear":
            pot = pot + eps_pa * (lam1_pa + lam2_pa * jnp.sqrt(d2s))
        e = jnp.sum(jnp.where(mask_lj, pot, 0.0))

        overlap = jnp.zeros((), bool)
        if use_coul:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            qq = q_t[:, None] * charges_flat[None, :]
            overlap = jnp.any((d2 < params.d2_overlap) & (qq < 0.0) & mask_qq)
            if params.coulomb == "ewald":
                e = e + ewald_ops.real_space_sum(d2, qq, mask_qq, kappa)
            elif params.coulomb == "wolf":
                shifted = params.wolf_style == "pairwise"
                e = e + wolf_ops.wolf_pair_sum(
                    d2, qq, mask_qq, kappa, params.qq_cut, shifted=shifted)
            elif params.coulomb == "bare":
                r = jnp.sqrt(d2s)
                e = e + factor * jnp.sum(jnp.where(mask_qq, qq / r, 0.0))
            else:
                raise ValueError(params.coulomb)
        return e, overlap

    def pose_sfac(ra, box):
        return ewald_ops.structure_factor(ra, q_t, kv, box)

    def self_intra(box):
        """Position-independent energy constant of ONE molecule of this
        species (enters insertion/deletion deltas; cancels in moves)."""
        if not use_coul or params.coulomb == "bare":
            return jnp.zeros((), dtype)
        kappa = jnp.asarray(params.kappa_L, dtype) / box
        if params.coulomb == "ewald":
            e = ewald_ops.ewald_self(q_t, kappa)
            if P > 1:
                # rigid-body intra term: orientation-independent, so
                # evaluate on the body frame itself
                e = e + ewald_ops.ewald_intra(body_t[None], q_t[None],
                                              kappa, box)
            return e
        # wolf (both styles share the self/background term)
        return wolf_ops.wolf_self(q_t, kappa, params.qq_cut)

    def wolf_const_coeff(box):
        """E_const = coeff * Q_tot^2 for the reference-Wolf convention
        (reference `Ewald/energy.jl:924-931`); 0 otherwise."""
        if params.coulomb != "wolf" or params.wolf_style == "pairwise":
            return jnp.zeros((), dtype)
        kappa = jnp.asarray(params.kappa_L, dtype) / box
        return -factor * jax.scipy.special.erfc(
            kappa * params.qq_cut) / params.qq_cut

    def lrc_delta(box):
        if not use_lrc:
            return jnp.zeros((), dtype)
        vol = box**3
        return (tail_ops.lrc_energy(counts_plus, eps_tab, sig_tab,
                                    params.r_cut, vol)
                - tail_ops.lrc_energy(counts, eps_tab, sig_tab,
                                      params.r_cut, vol))

    # fluctuating-N LRC machinery: per-molecule type-count vector and
    # the species self-coefficient g(box) with U_lrc = g N^2 (see
    # ops/tail.mol_tail_coeff).  Same gating as lrc_delta: active only
    # for use_lrc with the unshifted potential.
    t_vec = np.bincount(tm, minlength=np.asarray(system.eps_table)
                        .shape[0]).astype(np.float64)
    c_mm = tail_ops.mol_tail_coeff(t_vec, t_vec, system.eps_table,
                                   system.sig_table, params.r_cut) \
        if use_lrc else 0.0

    def lrc_self_coeff(box):
        """g(box) = (8 pi / 3 box^3) c_mm, the LRC analog of
        wolf_const_coeff: U_lrc = g * N^2 for N molecules of this
        species, so exchange deltas are g*((N+dn)^2 - N^2)."""
        if c_mm == 0.0:
            return jnp.zeros((), dtype)
        return jnp.asarray(tail_ops.LRC_PREFACTOR * c_mm, dtype) / box**3

    return SimpleNamespace(
        P=P, q_t=q_t, q_t_tot=q_t_tot, q_sys_tot=q_sys_tot, body_t=body_t,
        pose_atoms=pose_atoms, pair_energy=pair_energy, pose_sfac=pose_sfac,
        self_intra=self_intra, wolf_const_coeff=wolf_const_coeff,
        lrc_delta=lrc_delta, lrc_self_coeff=lrc_self_coeff, t_vec=t_vec,
        use_lrc=use_lrc, mol_of_atom=mol_of_atom, real=real,
        charges_flat=charges_flat)


def make_widom_fn(system, params, kvecs, kweights, dtype=jnp.float32,
                  species=0, chunk=8):
    """Build the insertion evaluators for one species.

    Returns (widom_du, widom_sample):
      widom_du(state, com_t (C, n, 3), quat_t (C, n, 4))
          -> (du (C, n), overlap (C, n)): exact insertion energies at
          given ghost poses (deterministic; used by tests and scans).
      widom_sample(state, key, n_insertions)
          -> (C,) mean Boltzmann factor <exp(-beta dU)> over n uniform
          random insertions per chain (overlap-vetoed ghosts count 0).

    chunk: chains per scan step (memory bound: each chunk row holds an
    (n, P, A_pad) pair grid).
    """
    ev = make_pose_eval(system, params, kvecs, kweights, dtype, species)
    P, M = ev.P, system.n_mol
    factor = jnp.asarray(COULOMB_FACTOR, dtype)
    use_coul = params.coulomb != "none"
    kv = None if kvecs is None else jnp.asarray(kvecs)
    kw = None if kweights is None else jnp.asarray(kweights, dtype)

    def du_one(com_t, quat_t, coords_t, com, box, sfac):
        """Insertion energy of ONE ghost pose in ONE chain.
        com_t (3,), quat_t (4,), coords_t (3, A_pad), com (M, 3)."""
        ra = ev.pose_atoms(com_t, quat_t)
        du, overlap = ev.pair_energy(com_t, ra, coords_t, com, box,
                                     ev.real, -1)
        du = du + ev.lrc_delta(box)
        if use_coul:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            if params.coulomb == "ewald":
                cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
                s_t = ev.pose_sfac(ra, box)
                du = du + ewald_ops.recip_energy_delta(sfac, s_t, cf)
                du = du + ev.self_intra(box)
                if params.ewald_surface:
                    com_all = com[jnp.clip(ev.mol_of_atom, 0, M - 1)]
                    m_tot = ewald_ops.surface_dipole(
                        coords_t.T, com_all, ev.charges_flat, box)
                    mu_t = ewald_ops.surface_dipole(
                        ra, com_t[None, :], ev.q_t, box)
                    c_surf = factor * 2.0 * jnp.pi / (3.0 * box**3)
                    m_new = m_tot + mu_t
                    du = du + c_surf * (jnp.sum(m_new * m_new)
                                        - jnp.sum(m_tot * m_tot))
            elif params.coulomb == "wolf":
                du = du + ev.self_intra(box)
                # reference-convention constant: coeff * Q^2 increments
                # by (Q + q_t)^2 - Q^2
                dq2 = (ev.q_sys_tot + ev.q_t_tot) ** 2 - ev.q_sys_tot**2
                du = du + ev.wolf_const_coeff(box) * dq2
        return du, overlap

    def widom_du(state, com_t, quat_t):
        """Exact insertion energies at given poses.
        com_t (C, n, 3), quat_t (C, n, 4) -> (du, overlap), each (C, n)."""
        def chain(coords, com, box, sfac, ct, qt):
            f = lambda c1, q1: du_one(c1, q1, coords, com, box, sfac)  # noqa: E731
            return jax.vmap(f)(ct, qt)

        return chunked_vmap(chain, chunk,
                            state.coords.astype(dtype),
                            state.com.astype(dtype),
                            state.box.astype(dtype),
                            state.sfac.astype(dtype),
                            com_t.astype(dtype), quat_t.astype(dtype))

    def widom_sample(state, key, n_insertions):
        """Mean Boltzmann factor over n uniform ghost poses per chain."""
        C = state.com.shape[0]
        k_pos, k_rot = jax.random.split(jnp.asarray(key))
        u = jax.random.uniform(k_pos, (C, n_insertions, 3), dtype)
        com_t = u * state.box.astype(dtype)[:, None, None]
        if P > 1:
            quat_t = random_quaternion(k_rot, (C, n_insertions), dtype)
        else:
            quat_t = jnp.zeros((C, n_insertions, 4), dtype) \
                .at[..., 0].set(1.0)
        du, ovr = widom_du(state, com_t, quat_t)
        beta_du = du / state.temp.astype(dtype)[:, None]
        b = jnp.where(ovr, 0.0, jnp.exp(-beta_du))
        return jnp.mean(b, axis=-1)

    return widom_du, widom_sample
