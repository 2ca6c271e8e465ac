"""Osmotic-ensemble MC: grand-canonical SOLUTE exchange in a fixed
amount of SOLVENT (mu_solute V T N_solvent).

The solubility workhorse (Henry constants, gas/solute loading in a
liquid — e.g. amine solvents for CO2 capture, the application the
reference ships `mea.pdb`/`topol.top` for): the solvent molecule count
is fixed while solute molecules exchange with a reservoir at activity
z.  Neither the reference (NVT-only) nor the single-species muVT app
(`mc/gcmc_mol.py`) covers this; it composes the same machinery:

  * a TWO-species-block System (solvent block first, solute block
    last, both internally uniform; the solute block's count IS the
    slot capacity) — ragged species-blocked storage as in mixtures;
  * one `widom.make_pose_eval` per species: displacements/rotations
    evaluate BOTH species' poses and where-select by the picked
    molecule's block (solvent always active; solute masked);
  * solute insertions/deletions exactly as in gcmc_mol, including the
    orientational-bias (Rosenbluth) option and the carried per-chain
    Ewald structure factors (solvent moves update them too).

Exactness anchors (tests/test_gcmc_osmotic.py):
  * all-slots-active full energy == models/energy.energy_breakdown of
    the two-species system (exact);
  * non-interacting solute in an interacting solvent: N ~ Poisson(zV)
    (the solvent cannot influence an ideal solute);
  * Henry-law consistency: beta mu_ex = ln(z / <rho_u>) vs the Widom
    machinery (species=solute) on an NVT run of the main driver at the
    sampled composition;
  * Ewald drift + structure-factor drift through solvent moves and
    solute exchanges in one run.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.mc.gcmc_mol import (
    make_trial_quats,
    rosenbluth,
)
from metropolismontecarlo_tpu.mc.widom import make_pose_eval
from metropolismontecarlo_tpu.ops import ewald as ewald_ops
from metropolismontecarlo_tpu.ops.quaternions import (
    random_quaternion,
    random_rotate_quaternion,
)
from metropolismontecarlo_tpu.utils.activity import clear_slot, set_slot
from metropolismontecarlo_tpu.utils.chunking import chunked_vmap


class OsmoticState(NamedTuple):
    com: jnp.ndarray      # (C, M, 3)  M = n_solvent + capacity
    quat: jnp.ndarray     # (C, M, 4)
    coords: jnp.ndarray   # (C, 3, A_pad)
    active: jnp.ndarray   # (C, cap) bool — SOLUTE slots only
    box: jnp.ndarray      # (C,)
    sfac: jnp.ndarray     # (C, K, 2)
    energy: jnp.ndarray   # (C,)
    key: jnp.ndarray      # (C, 2)
    acc: jnp.ndarray      # (C, 4) [trans, rot, insert, delete]
    att: jnp.ndarray      # (C, 4)


def make_gcmc_osmotic(system, params, activity, p_exchange=0.3,
                      dtype=jnp.float64, chunk=8, n_orient=1):
    """Build the osmotic-ensemble step/energy functions.

    system: a System with EXACTLY two species blocks — (solvent, count
    Ns) then (solute, capacity) — each internally uniform (one
    body/charge/type template per block, the from_topology convention).
    Returns (init, run_steps, full_energy) shaped as in gcmc_mol.
    """
    slices = system.species_slices
    if len(slices) != 2:
        raise ValueError("osmotic GCMC requires exactly two species "
                         "blocks: (solvent, n_solvent) + (solute, "
                         "capacity); got "
                         f"{[s[0] for s in slices]}")
    if not system.species_uniform:
        raise ValueError("each species block must be internally uniform")
    if params.ewald_surface or params.nlist_width != 0:
        raise ValueError("ewald_surface / neighbor lists are not "
                         "supported in osmotic GCMC")
    use_ewald = params.coulomb == "ewald"
    if use_ewald:
        kvecs, kweights = ewald_ops.make_kvectors(params.nk, params.ksq_max)
    else:
        kvecs = kweights = None

    ev0 = make_pose_eval(system, params, kvecs, kweights, dtype, species=0)
    ev1 = make_pose_eval(system, params, kvecs, kweights, dtype, species=1)
    if use_ewald and abs(ev1.q_t_tot) > 1e-5:
        raise ValueError("ewald osmotic GCMC requires a charge-neutral "
                         f"solute (net charge {ev1.q_t_tot})")
    _, m0_s, m1_s, P0, a0_s = slices[0]
    _, m0_u, m1_u, P1, a0_u = slices[1]
    ns = m1_s - m0_s                      # solvent molecules (fixed)
    cap = m1_u - m0_u                     # solute slots
    if ns < 1 or cap < 1:
        raise ValueError(f"need >= 1 solvent molecule and >= 1 solute "
                         f"slot (got {ns}, {cap}); with zero active "
                         "molecules the move pick would land on an "
                         "inactive slot and corrupt the carried state")
    M = system.n_mol
    A, A_pad = system.n_atoms, system.n_atoms_padded
    K = len(kvecs) if use_ewald else 1
    kv = None if kvecs is None else jnp.asarray(kvecs)
    kw = None if kweights is None else jnp.asarray(kweights, dtype)
    mol_of_atom = jnp.asarray(system.mol_of_atom_padded)
    real = mol_of_atom >= 0
    solute_col = (mol_of_atom >= m0_u) & real      # (A_pad,)
    q_t2 = ev1.q_t_tot**2

    beta = jnp.asarray(1.0 / params.temperature, dtype)
    z = jnp.asarray(activity, dtype)
    px = float(p_exchange)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    neg_inf = jnp.asarray(-jnp.inf, dtype)

    def atom_ok_of(active):
        """Solvent columns always on; solute columns by slot activity."""
        slot = jnp.clip(mol_of_atom - m0_u, 0, cap - 1)
        return real & (~solute_col | active[slot])

    def write_pose(coords, a0, width, ra, keep):
        cur = jax.lax.dynamic_slice(coords, (0, a0), (3, width))
        new = jnp.where(keep, ra.T, cur)
        return jax.lax.dynamic_update_slice(coords, new, (0, a0))

    def solute_a0(slot):
        return a0_u + slot * P1

    # LJ tail coefficients (ops/tail.mol_tail_coeff): solute-solute
    # quadratic + solute-solvent cross with the FIXED solvent count
    use_lrc = ev1.use_lrc
    if use_lrc:
        from metropolismontecarlo_tpu.ops import tail as tail_ops
        c_uu = tail_ops.mol_tail_coeff(ev1.t_vec, ev1.t_vec,
                                       system.eps_table,
                                       system.sig_table, params.r_cut)
        c_uv = tail_ops.mol_tail_coeff(ev1.t_vec, ev0.t_vec,
                                       system.eps_table,
                                       system.sig_table, params.r_cut)
        c_vv = tail_ops.mol_tail_coeff(ev0.t_vec, ev0.t_vec,
                                       system.eps_table,
                                       system.sig_table, params.r_cut)

        def lrc_g(box, c):
            return jnp.asarray(tail_ops.LRC_PREFACTOR * c, dtype) \
                / box**3

    def exchange_const(box, n_old, dn):
        c = ev1.self_intra(box) * dn
        if q_t2 != 0.0:
            # reference-Wolf global constant tracks the TOTAL charge
            # (solvent + active solutes); a neutral solute (q_t2 == 0)
            # leaves Q_tot unchanged regardless of the solvent's charge
            q_tot = ns * ev0.q_t_tot + n_old.astype(dtype) * ev1.q_t_tot
            c = c + ev1.wolf_const_coeff(box) \
                * ((q_tot + dn * ev1.q_t_tot) ** 2 - q_tot**2)
        if use_lrc:
            nf = n_old.astype(dtype)
            c = c + lrc_g(box, c_uu) * ((nf + dn) ** 2 - nf**2) \
                + 2.0 * lrc_g(box, c_uv) * dn * ns
        return c

    trial_quats = make_trial_quats(P1, dtype)

    def pose_batch1(com_t, quats, coords, com, box, a_ok, excl, sfac_base,
                    cf):
        """Solute-pose trial energies (see gcmc_mol.pose_batch)."""
        def one(q):
            ra = ev1.pose_atoms(com_t, q)
            e_p, ovr = ev1.pair_energy(com_t, ra, coords, com, box, a_ok,
                                       excl)
            if use_ewald:
                s = ev1.pose_sfac(ra, box)
                e_p = e_p + ewald_ops.recip_energy_delta(sfac_base, s, cf)
            else:
                s = jnp.zeros((K, 2), dtype)
            return e_p, ovr, s

        return jax.vmap(one)(quats)

    def _one_step(carry, _):
        com, quat, coords, active, box, sfac, e, key, acc, att = carry
        key, k = jax.random.split(key)
        (k_move, k_sel, k_pos, k_rot, k_insq, k_delq, k_pick,
         k_acc) = jax.random.split(k, 8)
        n_u = jnp.sum(active.astype(jnp.int32))
        nf = n_u.astype(dtype)
        u_move = jax.random.uniform(k_move, dtype=dtype)
        mt = jnp.where(u_move < p_disp, 0,
                       jnp.where(u_move < p_disp + p_rot, 1,
                                 jnp.where(u_move < p_disp + p_rot
                                           + 0.5 * px, 2, 3)))
        a_ok = atom_ok_of(active)

        # --- pick one ACTIVE molecule uniformly (solvent always active)
        active_all = jnp.concatenate(
            [jnp.ones((ns,), bool), active])            # (M,)
        n_tot = ns + n_u
        u_sel = jax.random.uniform(k_sel, dtype=dtype)
        csum = jnp.cumsum(active_all.astype(jnp.int32))
        idx = jnp.argmax(csum >= jnp.floor(
            u_sel * n_tot.astype(dtype)).astype(jnp.int32) + 1)
        is_solv = idx < ns
        com_i, quat_i = com[idx], quat[idx]

        if use_ewald:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
        else:
            cf = None

        # --- old/new pose energies for BOTH species, where-selected
        # (statically skipped in exchange-only builds) -----------------
        move_on = p_disp + p_rot > 0.0
        if move_on:
            disp = (jax.random.uniform(k_pos, (3,), dtype) - 0.5) \
                * params.dr_max
            com_new = jnp.where(mt == 0, (com_i + disp) % box, com_i)
            quat_new = jnp.where(mt == 1,
                                 random_rotate_quaternion(
                                     k_rot, quat_i, params.dphi_max),
                                 quat_i)

            def species_pair(ev_s):
                ra_o = ev_s.pose_atoms(com_i, quat_i)
                e_o, _ = ev_s.pair_energy(com_i, ra_o, coords, com, box,
                                          a_ok, idx)
                ra_n = ev_s.pose_atoms(com_new, quat_new)
                e_n, ovr_n = ev_s.pair_energy(com_new, ra_n, coords,
                                              com, box, a_ok, idx)
                if use_ewald:
                    s_o = ev_s.pose_sfac(ra_o, box)
                    s_n = ev_s.pose_sfac(ra_n, box)
                else:
                    s_o = s_n = jnp.zeros((K, 2), dtype)
                return ra_o, ra_n, e_o, e_n, ovr_n, s_o, s_n

            ra0_o, ra0_n, e0_o, e0_n, ovr0, s0_o, s0_n = \
                species_pair(ev0)
            ra1_o, ra1_n, e1_o, e1_n, ovr1, s1_o, s1_n = \
                species_pair(ev1)
            e_old = jnp.where(is_solv, e0_o, e1_o)
            e_new = jnp.where(is_solv, e0_n, e1_n)
            ovr_new = jnp.where(is_solv, ovr0, ovr1)
            s_old = jnp.where(is_solv, s0_o, s1_o)
            s_new = jnp.where(is_solv, s0_n, s1_n)
            d_move = ewald_ops.recip_energy_delta(sfac, s_new - s_old,
                                                  cf) \
                if use_ewald else jnp.zeros((), dtype)
            du_move = e_new - e_old + d_move

        # --- solute insertion (k trial orientations) --------------------
        com_ins = jax.random.uniform(k_pos, (3,), dtype) * box
        quats_i = trial_quats(k_insq, n_or)
        u_i, ovr_i, s_i = pose_batch1(com_ins, quats_i, coords, com, box,
                                      a_ok, -1, sfac, cf)
        slot = jnp.argmax(~active)
        full = n_u >= cap
        m_i, w_i = rosenbluth(jnp.where(ovr_i, neg_inf, -beta * u_i))
        w_sum_i = jnp.sum(w_i)
        u_pick = jax.random.uniform(k_pick, dtype=dtype)
        j_sel = jnp.argmax(jnp.cumsum(w_i) > u_pick * w_sum_i)
        quat_ins = quats_i[j_sel]
        ra_ins = ev1.pose_atoms(com_ins, quat_ins)
        s_ins = s_i[j_sel]
        ec_ins = exchange_const(box, n_u, +1.0)
        du_ins = u_i[j_sel] + ec_ins

        # --- solute deletion (existing + k-1 trials) --------------------
        # deletion picks uniformly among ACTIVE SOLUTES — an independent
        # pick from the all-molecule displacement pick (the two are used
        # by DISJOINT move types, so reusing k_sel's uniform is harmless)
        ec_del = exchange_const(box, n_u, -1.0)
        u_sel2 = jax.random.uniform(k_sel, dtype=dtype)
        csum_u = jnp.cumsum(active.astype(jnp.int32))
        slot_del = jnp.argmax(csum_u >= jnp.floor(u_sel2 * nf)
                              .astype(jnp.int32) + 1)
        com_d, quat_d = com[ns + slot_del], quat[ns + slot_del]
        ra_d = ev1.pose_atoms(com_d, quat_d)
        e_d, _ = ev1.pair_energy(com_d, ra_d, coords, com, box, a_ok,
                                 ns + slot_del)
        if use_ewald:
            s_d = ev1.pose_sfac(ra_d, box)
            sfac_wo_d = sfac - s_d
            u_exist_d = e_d + ewald_ops.recip_energy_delta(sfac_wo_d, s_d,
                                                           cf)
        else:
            s_d = jnp.zeros((K, 2), dtype)
            sfac_wo_d = sfac
            u_exist_d = e_d
        if n_or > 1:
            quats_d = trial_quats(k_delq, n_or - 1)
            u_dd, ovr_dd, _ = pose_batch1(com_d, quats_d, coords, com,
                                          box, a_ok, ns + slot_del,
                                          sfac_wo_d, cf)
            neg_dd = jnp.concatenate([(-beta * u_exist_d)[None],
                                      jnp.where(ovr_dd, neg_inf,
                                                -beta * u_dd)])
        else:
            neg_dd = (-beta * u_exist_d)[None]
        m_dd, w_dd = rosenbluth(neg_dd)
        w_sum_dd = jnp.sum(w_dd)
        du_del = -u_exist_d + ec_del

        # --- acceptance -------------------------------------------------
        vol = box**3
        u = jax.random.uniform(k_acc, dtype=dtype)
        ln_u = jnp.log(jnp.maximum(u, jnp.asarray(1e-300, dtype)))
        if move_on:
            ok_m = (mt <= 1) & ~ovr_new \
                & (u < jnp.exp(-beta * du_move))
        else:
            ok_m = jnp.asarray(False)
        ln_acc_i = jnp.log(z * vol / (nf + 1.0)) + m_i \
            + jnp.log(jnp.maximum(w_sum_i, 1e-300)) - float(np.log(n_or)) \
            - beta * ec_ins
        ok_i = (mt == 2) & ~full & (w_sum_i > 0.0) & (ln_u < ln_acc_i)
        ln_acc_d = jnp.log(jnp.maximum(nf, 1.0) / (z * vol)) \
            + float(np.log(n_or)) - m_dd \
            - jnp.log(jnp.maximum(w_sum_dd, 1e-300)) - beta * ec_del
        ok_d = (mt == 3) & (n_u > 0) & (ln_u < ln_acc_d)

        # --- apply ------------------------------------------------------
        if move_on:
            com = com.at[idx].set(jnp.where(ok_m, com_new, com[idx]))
            quat = quat.at[idx].set(jnp.where(ok_m, quat_new,
                                              quat[idx]))
            # conditional writes per species width
            a0_m0 = jnp.where(is_solv, a0_s + idx * P0, 0)
            coords = write_pose(coords, a0_m0, P0, ra0_n,
                                ok_m & is_solv)
            a0_m1 = jnp.where(is_solv, 0, solute_a0(idx - ns))
            coords = write_pose(coords, a0_m1, P1, ra1_n,
                                ok_m & ~is_solv)
        com = com.at[ns + slot].set(jnp.where(ok_i, com_ins,
                                              com[ns + slot]))
        quat = quat.at[ns + slot].set(jnp.where(ok_i, quat_ins,
                                                quat[ns + slot]))
        coords = write_pose(coords, solute_a0(slot), P1, ra_ins, ok_i)
        # one-hot where-selects, never bool scatters (utils/activity.py:
        # the bool-scatter hazard)
        active = set_slot(active, slot, ok_i)
        active = clear_slot(active, slot_del, ok_d)
        sfac = sfac + jnp.where(ok_i, 1.0, 0.0) * s_ins \
            - jnp.where(ok_d, 1.0, 0.0) * s_d
        e = e + jnp.where(ok_i, du_ins, 0.0) \
            + jnp.where(ok_d, du_del, 0.0)
        if move_on:
            w_m = jnp.where(ok_m, 1.0, 0.0)
            sfac = sfac + w_m * (s_new - s_old)
            e = e + jnp.where(ok_m, du_move, 0.0)
        a_row = jnp.stack([ok_m & (mt == 0), ok_m & (mt == 1),
                           ok_i, ok_d]).astype(jnp.int32)
        t_row = (jnp.arange(4) == mt).astype(jnp.int32)
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

        def pose_e0(m):
            ra = ev0.pose_atoms(com[m], quat[m])
            e_m, _ = ev0.pair_energy(com[m], ra, coords, com, box, a_ok, m)
            return e_m

        def pose_e1(j):
            m = ns + j
            ra = ev1.pose_atoms(com[m], quat[m])
            e_m, _ = ev1.pair_energy(com[m], ra, coords, com, box, a_ok, m)
            return jnp.where(active[j], e_m, 0.0)

        e = 0.5 * (jnp.sum(jax.vmap(pose_e0)(jnp.arange(ns)))
                   + jnp.sum(jax.vmap(pose_e1)(jnp.arange(cap))))
        nf = jnp.sum(active.astype(dtype))
        e = e + ns * ev0.self_intra(box) + nf * ev1.self_intra(box)
        q_tot = ns * ev0.q_t_tot + nf * ev1.q_t_tot
        # the wolf_const_coeff is species-independent (style/box only)
        e = e + ev1.wolf_const_coeff(box) * q_tot * q_tot
        if use_lrc:
            e = e + lrc_g(box, c_uu) * nf * nf \
                + 2.0 * lrc_g(box, c_uv) * nf * ns \
                + lrc_g(box, c_vv) * float(ns) ** 2
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
        return OsmoticState(*out)

    def init(key, box, n_init, n_chains):
        """Lattice placement of ALL M = ns + cap molecule sites; the
        first n_init solute slots start active."""
        if n_init > cap:
            raise ValueError("n_init exceeds solute capacity")
        if params.strict_min_image and box < 2.0 * max(params.r_cut,
                                                       params.qq_cut):
            raise ValueError(f"box {box} < 2*cutoff violates minimum-"
                             "image (set strict_min_image=False to "
                             "sample the truncated model)")
        k_chain, k_quat = jax.random.split(jnp.asarray(key))
        keys = jax.random.split(k_chain, n_chains)
        from metropolismontecarlo_tpu.io.configs import cubic_lattice
        lat = jnp.asarray(cubic_lattice(M, box), dtype)
        com = jnp.broadcast_to(lat[None], (n_chains, M, 3))
        quat = random_quaternion(k_quat, (n_chains, M), dtype) \
            if max(P0, P1) > 1 else \
            jnp.zeros((n_chains, M, 4), dtype).at[..., 0].set(1.0)
        ra0 = jax.vmap(jax.vmap(ev0.pose_atoms))(
            com[:, :ns], quat[:, :ns])               # (C, ns, P0, 3)
        ra1 = jax.vmap(jax.vmap(ev1.pose_atoms))(
            com[:, ns:], quat[:, ns:])               # (C, cap, P1, 3)
        flat = jnp.concatenate([ra0.reshape(n_chains, ns * P0, 3),
                                ra1.reshape(n_chains, cap * P1, 3)], 1)
        coords = jnp.swapaxes(flat, 1, 2)
        coords = jnp.pad(coords, ((0, 0), (0, 0), (0, A_pad - A)))
        active = jnp.broadcast_to(jnp.arange(cap) < n_init,
                                  (n_chains, cap))
        state = OsmoticState(
            com=com, quat=quat, coords=coords, active=active,
            box=jnp.full((n_chains,), box, dtype),
            sfac=jnp.zeros((n_chains, K, 2), dtype),
            energy=jnp.zeros((n_chains,), dtype), key=keys,
            acc=jnp.zeros((n_chains, 4), jnp.int32),
            att=jnp.zeros((n_chains, 4), jnp.int32))
        e, sf = full_energy(state)
        return state._replace(energy=e, sfac=sf)

    return init, run_steps, full_energy


class OsmoticGCMC:
    """Driver wrapper: blocks with the drift invariant and solute-N
    statistics.

    >>> g = OsmoticGCMC(two_species_system, params, activity=1e-3)
    >>> st = g.init(key, box=20.0, n_init=4, n_chains=64)
    >>> st, stats = g.run_block(st, 2000, drift_tol=1e-9)
    """

    def __init__(self, system, params, activity, p_exchange=0.3,
                 dtype=jnp.float64, chunk=8, n_orient=1):
        self.params = params
        self._init, self.run_steps, self.full_energy = make_gcmc_osmotic(
            system, params, activity, p_exchange, dtype, chunk, n_orient)
        self.capacity = system.species_slices[1][2] \
            - system.species_slices[1][1]
        self.n_solvent = system.species_slices[0][2] \
            - system.species_slices[0][1]
        self._system = system

    def init(self, key, box, n_init, n_chains):
        return self._init(key, box, n_init, n_chains)

    def atom_mask(self, state):
        """(C, A_pad) per-atom activity mask: solvent columns always on,
        solute columns by slot activity (for the masked RDF)."""
        moa = np.asarray(self._system.mol_of_atom_padded)
        m0_u = self._system.species_slices[1][1]
        real = moa >= 0
        solute = (moa >= m0_u) & real
        slot = jnp.asarray(np.clip(moa - m0_u, 0, self.capacity - 1))
        return jnp.asarray(real)[None, :] \
            & (jnp.asarray(~solute)[None, :] | state.active[:, slot])

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
        n = jnp.sum(state.active, axis=1)
        ratio = (state.acc - acc0) / jnp.maximum(state.att - att0, 1)
        stats = {
            "n_mean": float(jnp.mean(n.astype(jnp.float64))),
            "n_var": float(jnp.var(n.astype(jnp.float64))),
            "full_frac": float(jnp.mean((n >= self.capacity)
                                        .astype(jnp.float64))),
            "energy_mean": float(jnp.mean(e)),
            "acc_trans": float(jnp.mean(ratio[:, 0])),
            "acc_rot": float(jnp.mean(ratio[:, 1])),
            "acc_insert": float(jnp.mean(ratio[:, 2])),
            "acc_delete": float(jnp.mean(ratio[:, 3])),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None:
            assert stats["drift_max_rel"] < drift_tol, stats
            assert not np.isnan(stats["energy_mean"]), stats
        return state._replace(energy=e, sfac=sf), stats
