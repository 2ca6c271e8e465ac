"""Semigrand-canonical MC: identity swaps between two species at fixed
total N (N_tot V T Delta-mu) — composition sampling for mixtures.

The last member of the ensemble family (after NVT/NPT, muVT, osmotic,
Gibbs, REMC): instead of exchanging molecules with a reservoir, a
molecule CHANGES SPECIES in place, controlled by the fugacity ratio

    xi = f_B / f_A = exp(beta Delta-mu)     (all internal/kinetic
                                             factors absorbed)

Flip acceptance for a uniformly picked active molecule (the proposal is
symmetric — the reverse move picks the same molecule — so no N-ratio
factors appear, unlike reservoir exchanges):

    A -> B:  min[1, xi   exp(-beta dU)]
    B -> A:  min[1, 1/xi exp(-beta dU)]

with the new identity placed at the SAME center of mass and a fresh
uniform orientation (optionally n_orient Rosenbluth trials, exactly as
in mc/gcmc_mol.py; the old identity's reverse set completes with k-1
trials).  In the ideal-gas limit each molecule is independently B with
probability xi/(1+xi), so N_B ~ Binomial(N_tot, xi/(1+xi)) — and for
PHYSICALLY IDENTICAL species the same closed form holds at ANY
interaction strength (relabeling cannot change the physics), which is
the app's exact statistical anchor with full Ewald water.

Slot design: a two-species-block System whose blocks BOTH have n_tot
slots (any molecule may be either species); per-slot activity masks
with sum(active) = n_tot conserved; a flip deactivates the molecule's
slot and activates a free slot of the other block at the same COM.
Displacements/rotations evaluate both species' poses and where-select,
as in mc/gcmc_osmotic.py.  Carried Ewald structure factors update
through flips (s_new_species - s_old_species).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.mc.gcmc_mol import make_trial_quats, rosenbluth
from metropolismontecarlo_tpu.mc.widom import make_pose_eval
from metropolismontecarlo_tpu.ops import ewald as ewald_ops
from metropolismontecarlo_tpu.ops.quaternions import (
    random_quaternion,
    random_rotate_quaternion,
)
from metropolismontecarlo_tpu.utils.activity import clear_slot, set_slot
from metropolismontecarlo_tpu.utils.chunking import chunked_vmap


class SemigrandState(NamedTuple):
    com: jnp.ndarray      # (C, M, 3)  M = cap_A + cap_B slots
    quat: jnp.ndarray     # (C, M, 4)
    coords: jnp.ndarray   # (C, 3, A_pad)
    active: jnp.ndarray   # (C, M) bool; sum per chain = n_tot (conserved)
    box: jnp.ndarray      # (C,)
    sfac: jnp.ndarray     # (C, K, 2)
    energy: jnp.ndarray   # (C,)
    key: jnp.ndarray      # (C, 2)
    acc: jnp.ndarray      # (C, 4) [disp, rot, flip A->B, flip B->A]
    att: jnp.ndarray      # (C, 4)


def make_semigrand(system, params, fugacity_ratio, p_flip=0.3,
                   dtype=jnp.float64, chunk=8, n_orient=1):
    """Build the semigrand step/energy functions.

    system: a System with EXACTLY two species blocks (A then B), each
    internally uniform; both block counts are slot CAPACITIES and must
    each be >= the fixed total molecule count chosen at init.
    fugacity_ratio: xi = f_B/f_A.  Returns (init, run_steps,
    full_energy) shaped as the other ensemble apps.
    """
    slices = system.species_slices
    if len(slices) != 2:
        raise ValueError("semigrand MC requires exactly two species "
                         f"blocks; got {[s[0] for s in slices]}")
    if not system.species_uniform:
        raise ValueError("each species block must be internally uniform")
    if params.ewald_surface or params.nlist_width != 0:
        raise ValueError("ewald_surface / neighbor lists are not "
                         "supported in semigrand MC")
    use_ewald = params.coulomb == "ewald"
    if use_ewald:
        kvecs, kweights = ewald_ops.make_kvectors(params.nk, params.ksq_max)
    else:
        kvecs = kweights = None

    ev0 = make_pose_eval(system, params, kvecs, kweights, dtype, species=0)
    ev1 = make_pose_eval(system, params, kvecs, kweights, dtype, species=1)
    if use_ewald and abs(ev1.q_t_tot - ev0.q_t_tot) > 1e-5:
        raise ValueError(
            "ewald semigrand requires equal species net charges (a flip "
            f"would change the background; got {ev0.q_t_tot} vs "
            f"{ev1.q_t_tot})")
    if params.coulomb == "wolf" and params.wolf_style != "pairwise" \
            and abs(ev1.q_t_tot - ev0.q_t_tot) > 1e-5:
        raise ValueError("reference-Wolf semigrand requires equal "
                         "species net charges (the global c*Q^2 term "
                         "would change per flip)")
    _, m0_a, m1_a, P0, a0_a = slices[0]
    _, m0_b, m1_b, P1, a0_b = slices[1]
    cap_a = m1_a - m0_a
    cap_b = m1_b - m0_b
    M = system.n_mol
    A, A_pad = system.n_atoms, system.n_atoms_padded
    K = len(kvecs) if use_ewald else 1
    kv = None if kvecs is None else jnp.asarray(kvecs)
    kw = None if kweights is None else jnp.asarray(kweights, dtype)
    mol_of_atom = jnp.asarray(system.mol_of_atom_padded)
    real = mol_of_atom >= 0

    beta = jnp.asarray(1.0 / params.temperature, dtype)
    ln_xi = float(np.log(fugacity_ratio))
    px = float(p_flip)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    neg_inf = jnp.asarray(-jnp.inf, dtype)
    trial_quats0 = make_trial_quats(P0, dtype)
    trial_quats1 = make_trial_quats(P1, dtype)

    def atom_ok_of(active):
        return real & active[jnp.clip(mol_of_atom, 0, M - 1)]

    def write_pose0(coords, m, ra, keep):
        cur = jax.lax.dynamic_slice(coords, (0, a0_a + m * P0), (3, P0))
        new = jnp.where(keep, ra.T, cur)
        return jax.lax.dynamic_update_slice(coords, new,
                                            (0, a0_a + m * P0))

    def write_pose1(coords, m_b, ra, keep):
        cur = jax.lax.dynamic_slice(coords, (0, a0_b + m_b * P1), (3, P1))
        new = jnp.where(keep, ra.T, cur)
        return jax.lax.dynamic_update_slice(coords, new,
                                            (0, a0_b + m_b * P1))

    def species_const(ev_s, box):
        return ev_s.self_intra(box)

    # LJ tail coefficients: U_lrc = (8 pi / 3V)(c00 n_a^2 +
    # 2 c01 n_a n_b + c11 n_b^2); a flip changes (n_a, n_b) by -+1 so
    # the delta is affine in the LIVE per-species counts
    # (ops/tail.mol_tail_coeff).  For identical species c00 = c01 = c11
    # and the flip delta cancels EXACTLY — the closed-form Binomial
    # anchor gates the cross-term algebra (tests/test_lrc_exchange.py).
    use_lrc = ev0.use_lrc
    if use_lrc:
        from metropolismontecarlo_tpu.ops import tail as tail_ops
        c00 = tail_ops.mol_tail_coeff(ev0.t_vec, ev0.t_vec,
                                      system.eps_table,
                                      system.sig_table, params.r_cut)
        c01 = tail_ops.mol_tail_coeff(ev0.t_vec, ev1.t_vec,
                                      system.eps_table,
                                      system.sig_table, params.r_cut)
        c11 = tail_ops.mol_tail_coeff(ev1.t_vec, ev1.t_vec,
                                      system.eps_table,
                                      system.sig_table, params.r_cut)

        def lrc_g(box):
            return jnp.asarray(tail_ops.LRC_PREFACTOR, dtype) / box**3

        def lrc_flip_delta(box, is_a, n_a, n_b):
            """U_lrc delta of flipping a->b (is_a) or b->a."""
            g = lrc_g(box)
            d_ab = -(2.0 * n_a - 1.0) * c00 + (2.0 * n_b + 1.0) * c11 \
                + 2.0 * (n_a - n_b - 1.0) * c01
            d_ba = (2.0 * n_a + 1.0) * c00 - (2.0 * n_b - 1.0) * c11 \
                + 2.0 * (n_b - n_a - 1.0) * c01
            return g * jnp.where(is_a, d_ab, d_ba)

    def pose_batch(ev_s, com_t, quats, coords, com, box, a_ok, excl,
                   sfac_base, cf):
        def one(q):
            ra = ev_s.pose_atoms(com_t, q)
            e_p, ovr = ev_s.pair_energy(com_t, ra, coords, com, box,
                                        a_ok, excl)
            if use_ewald:
                s = ev_s.pose_sfac(ra, box)
                e_p = e_p + ewald_ops.recip_energy_delta(sfac_base, s, cf)
            else:
                s = jnp.zeros((K, 2), dtype)
            return e_p, ovr, s

        return jax.vmap(one)(quats)

    def _one_step(carry, _):
        com, quat, coords, active, box, sfac, e, key, acc, att = carry
        key, k = jax.random.split(key)
        (k_move, k_sel, k_pos, k_rot, k_newq, k_oldq, k_pick,
         k_acc) = jax.random.split(k, 8)
        n_tot = jnp.sum(active.astype(jnp.int32))
        u_move = jax.random.uniform(k_move, dtype=dtype)
        # 0 displace, 1 rotate, 2 identity flip (direction = species of
        # the picked molecule)
        mt = jnp.where(u_move < p_disp, 0,
                       jnp.where(u_move < p_disp + p_rot, 1, 2))
        a_ok = atom_ok_of(active)

        # --- pick one active molecule uniformly -------------------------
        u_sel = jax.random.uniform(k_sel, dtype=dtype)
        csum = jnp.cumsum(active.astype(jnp.int32))
        idx = jnp.argmax(csum >= jnp.floor(
            u_sel * n_tot.astype(dtype)).astype(jnp.int32) + 1)
        is_a = idx < cap_a
        com_i, quat_i = com[idx], quat[idx]

        if use_ewald:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
        else:
            cf = None

        # --- old pose per species (the flip source needs these even in
        # flip-only builds) ----------------------------------------------
        def species_old(ev_s):
            ra_o = ev_s.pose_atoms(com_i, quat_i)
            e_o, _ = ev_s.pair_energy(com_i, ra_o, coords, com, box,
                                      a_ok, idx)
            s_o = ev_s.pose_sfac(ra_o, box) if use_ewald \
                else jnp.zeros((K, 2), dtype)
            return e_o, s_o

        e0_o, s0_o = species_old(ev0)
        e1_o, s1_o = species_old(ev1)
        e_old = jnp.where(is_a, e0_o, e1_o)
        s_old = jnp.where(is_a, s0_o, s1_o)

        # --- displacement / rotation (both species, where-select;
        # statically skipped in flip-only builds) -----------------------
        move_on = p_disp + p_rot > 0.0
        if move_on:
            disp = (jax.random.uniform(k_pos, (3,), dtype) - 0.5) \
                * params.dr_max
            com_new = jnp.where(mt == 0, (com_i + disp) % box, com_i)
            quat_new = jnp.where(mt == 1,
                                 random_rotate_quaternion(
                                     k_rot, quat_i, params.dphi_max),
                                 quat_i)

            def species_new(ev_s):
                ra_n = ev_s.pose_atoms(com_new, quat_new)
                e_n, ovr_n = ev_s.pair_energy(com_new, ra_n, coords,
                                              com, box, a_ok, idx)
                s_n = ev_s.pose_sfac(ra_n, box) if use_ewald \
                    else jnp.zeros((K, 2), dtype)
                return ra_n, e_n, ovr_n, s_n

            ra0_n, e0_n, ovr0, s0_n = species_new(ev0)
            ra1_n, e1_n, ovr1, s1_n = species_new(ev1)
            e_new = jnp.where(is_a, e0_n, e1_n)
            ovr_new = jnp.where(is_a, ovr0, ovr1)
            s_new = jnp.where(is_a, s0_n, s1_n)
            d_move = ewald_ops.recip_energy_delta(sfac, s_new - s_old,
                                                  cf) \
                if use_ewald else jnp.zeros((), dtype)
            du_move = e_new - e_old + d_move

        # --- identity flip at the same COM -------------------------------
        # old identity: existing orientation + k-1 trials (excl = idx,
        # recip vs sfac - s_old_species); new identity: k trials
        sfac_wo = sfac - s_old if use_ewald else sfac
        if use_ewald:
            u_exist = e_old + ewald_ops.recip_energy_delta(sfac_wo, s_old,
                                                           cf)
        else:
            u_exist = e_old
        if n_or > 1:
            # trials for the OLD identity (per species, where-select)
            q_old0 = trial_quats0(k_oldq, n_or - 1)
            u_o0, ov_o0, _ = pose_batch(ev0, com_i, q_old0, coords, com,
                                        box, a_ok, idx, sfac_wo, cf)
            q_old1 = trial_quats1(k_oldq, n_or - 1)
            u_o1, ov_o1, _ = pose_batch(ev1, com_i, q_old1, coords, com,
                                        box, a_ok, idx, sfac_wo, cf)
            u_o = jnp.where(is_a, u_o0, u_o1)
            ov_o = jnp.where(is_a, ov_o0, ov_o1)
            neg_o = jnp.concatenate([(-beta * u_exist)[None],
                                     jnp.where(ov_o, neg_inf,
                                               -beta * u_o)])
        else:
            neg_o = (-beta * u_exist)[None]
        m_o, w_o = rosenbluth(neg_o)
        w_sum_o = jnp.sum(w_o)

        # new identity trials (opposite species of the picked molecule)
        q_new0 = trial_quats0(k_newq, n_or)          # if flipping B->A
        q_new1 = trial_quats1(k_newq, n_or)          # if flipping A->B
        u_n0, ov_n0, s_n0 = pose_batch(ev0, com_i, q_new0, coords, com,
                                       box, a_ok, idx, sfac_wo, cf)
        u_n1, ov_n1, s_n1 = pose_batch(ev1, com_i, q_new1, coords, com,
                                       box, a_ok, idx, sfac_wo, cf)
        u_n = jnp.where(is_a, u_n1, u_n0)
        ov_n = jnp.where(is_a, ov_n1, ov_n0)
        s_n_tr = jnp.where(is_a, s_n1, s_n0)
        q_n_tr = jnp.where(is_a, q_new1, q_new0)
        m_n, w_n = rosenbluth(jnp.where(ov_n, neg_inf, -beta * u_n))
        w_sum_n = jnp.sum(w_n)
        u_pick = jax.random.uniform(k_pick, dtype=dtype)
        j_sel = jnp.argmax(jnp.cumsum(w_n) > u_pick * w_sum_n)
        quat_flip = q_n_tr[j_sel]
        s_flip = s_n_tr[j_sel]
        # constants: -const(old species) + const(new species)
        c0 = species_const(ev0, box)
        c1 = species_const(ev1, box)
        dconst = jnp.where(is_a, c1 - c0, c0 - c1)
        if use_lrc:
            n_a_f = jnp.sum(active[:cap_a].astype(dtype))
            n_b_f = jnp.sum(active[cap_a:].astype(dtype))
            dconst = dconst + lrc_flip_delta(box, is_a, n_a_f, n_b_f)
        du_flip = u_n[j_sel] - u_exist + dconst
        # target slot: first free slot of the OTHER block
        free_b = jnp.argmax(~active[cap_a:]) + cap_a
        free_a = jnp.argmax(~active[:cap_a])
        tgt = jnp.where(is_a, free_b, free_a)
        room = jnp.where(is_a, jnp.any(~active[cap_a:]),
                         jnp.any(~active[:cap_a]))

        # --- acceptance ---------------------------------------------------
        u = jax.random.uniform(k_acc, dtype=dtype)
        ln_u = jnp.log(jnp.maximum(u, jnp.asarray(1e-300, dtype)))
        if move_on:
            ok_m = (mt <= 1) & ~ovr_new & (u < jnp.exp(-beta * du_move))
        else:
            ok_m = jnp.asarray(False)
        ln_acc_f = jnp.where(is_a, ln_xi, -ln_xi) \
            + m_n + jnp.log(jnp.maximum(w_sum_n, 1e-300)) \
            - m_o - jnp.log(jnp.maximum(w_sum_o, 1e-300)) \
            - beta * dconst
        ok_f = (mt == 2) & room & (w_sum_n > 0.0) & (ln_u < ln_acc_f)

        # --- apply ---------------------------------------------------------
        if move_on:
            com = com.at[idx].set(jnp.where(ok_m, com_new, com[idx]))
            quat = quat.at[idx].set(jnp.where(ok_m, quat_new,
                                              quat[idx]))
            m_in_a = jnp.clip(idx, 0, cap_a - 1)
            m_in_b = jnp.clip(idx - cap_a, 0, cap_b - 1)
            coords = write_pose0(coords, m_in_a, ra0_n, ok_m & is_a)
            coords = write_pose1(coords, m_in_b, ra1_n, ok_m & ~is_a)
        # flip: move to tgt slot at the same COM, new orientation
        com = com.at[tgt].set(jnp.where(ok_f, com_i, com[tgt]))
        quat = quat.at[tgt].set(jnp.where(ok_f, quat_flip, quat[tgt]))
        t_in_a = jnp.clip(tgt, 0, cap_a - 1)
        t_in_b = jnp.clip(tgt - cap_a, 0, cap_b - 1)
        ra_f0 = ev0.pose_atoms(com_i, q_new0[j_sel])
        ra_f1 = ev1.pose_atoms(com_i, q_new1[j_sel])
        coords = write_pose1(coords, t_in_b, ra_f1, ok_f & is_a)
        coords = write_pose0(coords, t_in_a, ra_f0, ok_f & ~is_a)
        # one-hot where-selects, never bool scatters (utils/activity.py:
        # the bool-scatter hazard)
        active = set_slot(active, tgt, ok_f)
        active = clear_slot(active, idx, ok_f)
        w_f = jnp.where(ok_f, 1.0, 0.0)
        sfac = sfac + w_f * (s_flip - s_old)
        e = e + jnp.where(ok_f, du_flip, 0.0)
        if move_on:
            w_m = jnp.where(ok_m, 1.0, 0.0)
            sfac = sfac + w_m * (s_new - s_old)
            e = e + jnp.where(ok_m, du_move, 0.0)
        a_row = jnp.stack([ok_m & (mt == 0), ok_m & (mt == 1),
                           ok_f & is_a, ok_f & ~is_a]).astype(jnp.int32)
        t_row = jnp.stack([mt == 0, mt == 1, (mt == 2) & is_a,
                           (mt == 2) & ~is_a]).astype(jnp.int32)
        carry = (com, quat, coords, active, box, sfac, e, key,
                 acc + a_row, att + t_row)
        return carry, None

    def _run_chain(com, quat, coords, active, box, sfac, e, key, acc,
                   att, n_steps):
        carry = (com, quat, coords, active, box, sfac, e, key, acc, att)
        carry, _ = jax.lax.scan(_one_step, carry, None, length=n_steps)
        return carry

    def _full_one(com, quat, coords, active, box):
        a_ok = atom_ok_of(active)

        def pose_e(ev_s, m):
            ra = ev_s.pose_atoms(com[m], quat[m])
            e_m, _ = ev_s.pair_energy(com[m], ra, coords, com, box,
                                      a_ok, m)
            return jnp.where(active[m], e_m, 0.0)

        e_a = jnp.sum(jax.vmap(lambda m: pose_e(ev0, m))(
            jnp.arange(cap_a)))
        e_b = jnp.sum(jax.vmap(lambda m: pose_e(ev1, m))(
            jnp.arange(cap_a, M)))
        e = 0.5 * (e_a + e_b)
        n_a = jnp.sum(active[:cap_a].astype(dtype))
        n_b = jnp.sum(active[cap_a:].astype(dtype))
        e = e + n_a * species_const(ev0, box) \
            + n_b * species_const(ev1, box)
        q_tot = n_a * ev0.q_t_tot + n_b * ev1.q_t_tot
        e = e + ev1.wolf_const_coeff(box) * q_tot * q_tot
        if use_lrc:
            e = e + lrc_g(box) * (c00 * n_a * n_a + c11 * n_b * n_b
                                  + 2.0 * c01 * n_a * n_b)
        if use_ewald:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
            q_eff = jnp.where(a_ok, ev0.charges_flat, 0.0)
            sf = ewald_ops.structure_factor(coords.T, q_eff, kv, box)
            e = e + ewald_ops.recip_energy(sf, cf)
        else:
            sf = jnp.zeros((K, 2), dtype)
        return e, sf

    @jax.jit
    def full_energy(state):
        return chunked_vmap(_full_one, chunk, state.com, state.quat,
                            state.coords, state.active, state.box)

    @partial(jax.jit, static_argnums=1)
    def run_steps(state, n_steps):
        out = jax.vmap(_run_chain, in_axes=(0,) * 10 + (None,))(
            state.com, state.quat, state.coords, state.active, state.box,
            state.sfac, state.energy, state.key, state.acc, state.att,
            n_steps)
        return SemigrandState(*out)

    def init(key, box, n_a, n_b, n_chains):
        """n_a + n_b molecules total (conserved); requires n_a + n_b <=
        min(cap_A, cap_B) so either pure composition fits."""
        n_tot = int(n_a) + int(n_b)
        if n_tot < 1:
            raise ValueError("need at least one molecule (n_a + n_b >= 1)")
        if n_tot > min(cap_a, cap_b):
            raise ValueError(
                f"n_a + n_b = {n_tot} exceeds a block capacity "
                f"({cap_a}, {cap_b}) — every molecule must be able to "
                "flip to either species")
        if params.strict_min_image and box < 2.0 * max(params.r_cut,
                                                       params.qq_cut):
            raise ValueError(f"box {box} < 2*cutoff violates minimum-"
                             "image (set strict_min_image=False to "
                             "sample the truncated model)")
        k_chain, k_quat = jax.random.split(jnp.asarray(key))
        keys = jax.random.split(k_chain, n_chains)
        # ONE shared lattice of n_tot sites: active A slots take the
        # first n_a sites, active B slots the next n_b (inactive slots
        # park on the same lattice — masked, so overlaps are harmless)
        from metropolismontecarlo_tpu.io.configs import cubic_lattice
        lat = np.asarray(cubic_lattice(n_tot, box))
        com_np = np.zeros((M, 3))
        com_np[:cap_a] = lat[0]            # parked default
        com_np[:n_a] = lat[:n_a]
        com_np[cap_a:] = lat[0]
        com_np[cap_a:cap_a + n_b] = lat[n_a:n_tot]
        com = jnp.broadcast_to(jnp.asarray(com_np, dtype)[None],
                               (n_chains, M, 3))
        quat = random_quaternion(k_quat, (n_chains, M), dtype) \
            if max(P0, P1) > 1 else \
            jnp.zeros((n_chains, M, 4), dtype).at[..., 0].set(1.0)
        ra0 = jax.vmap(jax.vmap(ev0.pose_atoms))(
            com[:, :cap_a], quat[:, :cap_a])
        ra1 = jax.vmap(jax.vmap(ev1.pose_atoms))(
            com[:, cap_a:], quat[:, cap_a:])
        flat = jnp.concatenate(
            [ra0.reshape(n_chains, cap_a * P0, 3),
             ra1.reshape(n_chains, cap_b * P1, 3)], 1)
        coords = jnp.swapaxes(flat, 1, 2)
        coords = jnp.pad(coords, ((0, 0), (0, 0), (0, A_pad - A)))
        act = np.zeros(M, bool)
        act[:n_a] = True
        act[cap_a:cap_a + n_b] = True
        active = jnp.broadcast_to(jnp.asarray(act), (n_chains, M))
        state = SemigrandState(
            com=com, quat=quat, coords=coords, active=active,
            box=jnp.full((n_chains,), box, dtype),
            sfac=jnp.zeros((n_chains, K, 2), dtype),
            energy=jnp.zeros((n_chains,), dtype), key=keys,
            acc=jnp.zeros((n_chains, 4), jnp.int32),
            att=jnp.zeros((n_chains, 4), jnp.int32))
        e, sf = full_energy(state)
        return state._replace(energy=e, sfac=sf)

    return init, run_steps, full_energy


class Semigrand:
    """Driver wrapper: blocks with the drift invariant and composition
    statistics.

    >>> g = Semigrand(two_block_system, params, fugacity_ratio=2.0)
    >>> st = g.init(key, box=10.0, n_a=20, n_b=20, n_chains=128)
    >>> st, stats = g.run_block(st, 2000, drift_tol=1e-9)
    """

    def __init__(self, system, params, fugacity_ratio, p_flip=0.3,
                 dtype=jnp.float64, chunk=8, n_orient=1):
        self.params = params
        self._init, self.run_steps, self.full_energy = make_semigrand(
            system, params, fugacity_ratio, p_flip, dtype, chunk,
            n_orient)
        self.cap_a = system.species_slices[0][2] \
            - system.species_slices[0][1]

    def init(self, key, box, n_a, n_b, n_chains):
        return self._init(key, box, n_a, n_b, n_chains)

    def run_block(self, state, n_steps, drift_tol=None):
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        e, sf = self.full_energy(state)
        # both-endpoint drift scale (see mc/gcmc_mol.MolGCMC.run_block)
        scale = jnp.maximum(jnp.maximum(jnp.abs(e), jnp.abs(e_start)),
                            1.0)
        drift = jnp.max(jnp.abs(e - state.energy) / scale)
        sfac_err = jnp.max(jnp.abs(sf - state.sfac))
        n_b = jnp.sum(state.active[:, self.cap_a:], axis=1)
        n_tot = jnp.sum(state.active, axis=1)
        ratio = (state.acc - acc0) / jnp.maximum(state.att - att0, 1)
        stats = {
            "nb_mean": float(jnp.mean(n_b.astype(jnp.float64))),
            "nb_var": float(jnp.var(n_b.astype(jnp.float64))),
            "n_tot_mean": float(jnp.mean(n_tot.astype(jnp.float64))),
            "energy_mean": float(jnp.mean(e)),
            "acc_trans": float(jnp.mean(ratio[:, 0])),
            "acc_rot": float(jnp.mean(ratio[:, 1])),
            "acc_flip_ab": float(jnp.mean(ratio[:, 2])),
            "acc_flip_ba": float(jnp.mean(ratio[:, 3])),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None:
            assert stats["drift_max_rel"] < drift_tol, stats
            assert not np.isnan(stats["energy_mean"]), stats
        return state._replace(energy=e, sfac=sf), stats
