"""Binary-mixture grand-canonical MC: BOTH species exchange with
reservoirs at their own activities (mu_A mu_B V T).

The adsorption/selectivity ensemble (mixed-gas uptake, binary phase
behavior): extends the osmotic ensemble (`mc/gcmc_osmotic.py`, solute
exchange in FIXED solvent) to full two-component muVT.  Neither the
reference (NVT-only, `Ewald/main.jl`) nor the
single-species muVT apps cover this; it composes the same machinery:

  * a TWO-species-block System (each block internally uniform; each
    block's molecule count IS that species' slot capacity);
  * one `widom.make_pose_eval` per species; displacements/rotations
    pick uniformly among ALL active molecules and where-select the
    picked species' pose energies;
  * per-species insertions/deletions exactly as in gcmc_mol — incl.
    the orientational-bias (Rosenbluth) option — with the carried
    per-chain Ewald structure factors updated through every accepted
    move of either species.

Acceptance (per species s, independent reservoirs):

    insert:  min[1, z_s V / (N_s + 1) exp(-beta dU)]
    delete:  min[1, N_s / (z_s V)     exp(-beta dU)]

Exactness anchors (tests/test_gcmc_binary.py):
  * all-slots-active full energy == models/energy.energy_breakdown of
    the two-block system (exact, Ewald);
  * two ideal species: N_A ~ Poisson(z_A V) and N_B ~ Poisson(z_B V),
    independent;
  * COLOR symmetry: for two IDENTICAL interacting species at equal
    activities z, the total-N statistics equal single-species muVT at
    activity 2z (the labels are colors: Xi_binary(z, z) = Xi(2z)
    term-by-term) — an interacting closed-form anchor;
  * Ewald drift + structure-factor drift through mixed two-species
    exchanges (the framework-wide invariant).

Capacity truncation as in gcmc.py.  `use_lrc=True` adds the full
two-species quadratic tail U_lrc = (8 pi/3V) sum_ss' N_s N_s' c_ss'
(`ops/tail.mol_tail_coeff`) to the exchange constants and recompute.
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


class BinaryGCMCState(NamedTuple):
    com: jnp.ndarray      # (C, M, 3)   M = cap0 + cap1 slot COMs
    quat: jnp.ndarray     # (C, M, 4)
    coords: jnp.ndarray   # (C, 3, A_pad)
    active0: jnp.ndarray  # (C, cap0) bool — species-0 slots
    active1: jnp.ndarray  # (C, cap1) bool — species-1 slots
    box: jnp.ndarray      # (C,)
    sfac: jnp.ndarray     # (C, K, 2)
    energy: jnp.ndarray   # (C,)
    key: jnp.ndarray      # (C, 2)
    acc: jnp.ndarray      # (C, 6) [trans, rot, insA, delA, insB, delB]
    att: jnp.ndarray      # (C, 6)


def binary_atom_ok(system, active0, active1):
    """Per-atom activity mask for a two-species-block system, batched:
    active0 (..., cap0) and active1 (..., cap1) -> (..., A_pad) bool.

    The standalone (state-only) version of `make_binary_slots.
    atom_ok_of` for observable accumulation over ensemble states
    (e.g. MaskedRDFAccumulator over the liquid box of a binary Gibbs
    run) without building the pose evaluators."""
    slices = system.species_slices
    _, m0_a, m1_a, _, _ = slices[0]
    _, m0_b, m1_b, _, _ = slices[1]
    mol = jnp.asarray(system.mol_of_atom_padded)
    real = mol >= 0
    col_b = (mol >= m0_b) & real
    slot0 = jnp.clip(mol - m0_a, 0, (m1_a - m0_a) - 1)
    slot1 = jnp.clip(mol - m0_b, 0, (m1_b - m0_b) - 1)
    return real & jnp.where(col_b, active1[..., slot1],
                            active0[..., slot0])


def make_binary_slots(system, params, dtype=jnp.float64):
    """Shared two-species slot machinery for the binary ensembles
    (muVT here, two-box Gibbs in mc/gibbs_binary.py) — the two-species
    analogue of `make_mol_slots`.

    Validates the system/params combination, then returns a namespace:
      evs — one `widom.make_pose_eval` per species;
      caps, m0s, a0s, Ps — per-species slot counts / molecule / atom /
          width offsets;
      atom_ok_of(active0, active1) -> (A_pad,) per-atom activity mask;
      write_pose(coords, a0, width, ra, keep) — conditional dynamic
          write of one molecule's atom columns;
      exchange_const(box, n0, n1, s, dn) — position-independent energy
          delta of changing species s by dn (self + intra, the
          reference-Wolf c*Q_tot^2 tracking BOTH species' charges);
      pose_batch(s, ...) — species-s Rosenbluth trial evaluator;
      full_one(com, quat, coords, active0, active1, box) -> (e, sfac);
      pose_lattice_init(key, box, n_chains) -> (com, quat, coords);
      trial_quats, rosenbluth, plus fields M, A, A_pad, K, kv, kw,
      use_ewald.
    """
    from types import SimpleNamespace

    slices = system.species_slices
    if len(slices) != 2:
        raise ValueError("binary ensembles require exactly two species "
                         f"blocks; got {[s[0] for s in slices]}")
    if not system.species_uniform:
        raise ValueError("each species block must be internally uniform")
    if params.ewald_surface or params.nlist_width != 0:
        raise ValueError("ewald_surface / neighbor lists are not "
                         "supported in binary ensembles")
    use_ewald = params.coulomb == "ewald"
    if use_ewald:
        kvecs, kweights = ewald_ops.make_kvectors(params.nk,
                                                  params.ksq_max)
    else:
        kvecs = kweights = None

    evs = (make_pose_eval(system, params, kvecs, kweights, dtype,
                          species=0),
           make_pose_eval(system, params, kvecs, kweights, dtype,
                          species=1))
    if use_ewald:
        for s, ev in enumerate(evs):
            if abs(ev.q_t_tot) > 1e-5:
                raise ValueError(
                    "ewald binary ensembles require charge-neutral "
                    f"species (species {s} net charge {ev.q_t_tot})")
    _, m0_a, m1_a, P0, a0_a = slices[0]
    _, m0_b, m1_b, P1, a0_b = slices[1]
    caps = (m1_a - m0_a, m1_b - m0_b)
    m0s, a0s, Ps = (m0_a, m0_b), (a0_a, a0_b), (P0, P1)
    if min(caps) < 1:
        raise ValueError(f"each species needs >= 1 slot (got {caps})")
    M = system.n_mol
    A, A_pad = system.n_atoms, system.n_atoms_padded
    K = len(kvecs) if use_ewald else 1
    kv = None if kvecs is None else jnp.asarray(kvecs)
    kw = None if kweights is None else jnp.asarray(kweights, dtype)
    mol_of_atom = jnp.asarray(system.mol_of_atom_padded)
    real = mol_of_atom >= 0
    col_b = (mol_of_atom >= m0_b) & real           # species-1 columns
    trial_quats = tuple(make_trial_quats(P, dtype) for P in Ps)

    def atom_ok_of(active0, active1):
        slot0 = jnp.clip(mol_of_atom - m0_a, 0, caps[0] - 1)
        slot1 = jnp.clip(mol_of_atom - m0_b, 0, caps[1] - 1)
        return real & jnp.where(col_b, active1[slot1], active0[slot0])

    def write_pose(coords, a0, width, ra, keep):
        cur = jax.lax.dynamic_slice(coords, (0, a0), (3, width))
        new = jnp.where(keep, ra.T, cur)
        return jax.lax.dynamic_update_slice(coords, new, (0, a0))

    # species-level LJ tail coefficient matrix: U_lrc = (8 pi / 3V)
    # sum_ss' N_s N_s' c_lrc[s, s'] (ops/tail.mol_tail_coeff); active
    # only for use_lrc with the unshifted potential (evs gate it)
    use_lrc = evs[0].use_lrc
    if use_lrc:
        from metropolismontecarlo_tpu.ops import tail as tail_ops
        c_lrc = np.asarray(
            [[tail_ops.mol_tail_coeff(evs[a].t_vec, evs[b].t_vec,
                                      system.eps_table, system.sig_table,
                                      params.r_cut)
              for b in (0, 1)] for a in (0, 1)])

        def lrc_gmat(box):
            """(2, 2) per-volume coefficients g_ss'(box)."""
            return jnp.asarray(tail_ops.LRC_PREFACTOR * c_lrc, dtype) \
                / box**3
    else:
        lrc_gmat = None

    def exchange_const(box, n0, n1, s, dn):
        """Position-independent delta of changing species s by dn."""
        c = evs[s].self_intra(box) * dn
        q0, q1 = evs[0].q_t_tot, evs[1].q_t_tot
        if q0 != 0.0 or q1 != 0.0:
            q_tot = n0.astype(dtype) * q0 + n1.astype(dtype) * q1
            dq = dn * (q1 if s else q0)
            c = c + evs[s].wolf_const_coeff(box) \
                * ((q_tot + dq) ** 2 - q_tot**2)
        if use_lrc:
            g = lrc_gmat(box)
            nf_s = (n1 if s else n0).astype(dtype)
            nf_o = (n0 if s else n1).astype(dtype)
            o = 1 - s
            c = c + g[s, s] * ((nf_s + dn) ** 2 - nf_s**2) \
                + 2.0 * g[s, o] * dn * nf_o
        return c

    def pose_batch(s, com_t, quats, coords, com, box, a_ok, excl,
                   sfac_base, cf):
        """Species-s trial-pose energies (see gcmc_mol.pose_batch)."""
        def one(q):
            ra = evs[s].pose_atoms(com_t, q)
            e_p, ovr = evs[s].pair_energy(com_t, ra, coords, com, box,
                                          a_ok, excl)
            if use_ewald:
                sf = evs[s].pose_sfac(ra, box)
                e_p = e_p + ewald_ops.recip_energy_delta(sfac_base, sf,
                                                         cf)
            else:
                sf = jnp.zeros((K, 2), dtype)
            return e_p, ovr, sf

        return jax.vmap(one)(quats)

    def full_one(com, quat, coords, active0, active1, box):
        a_ok = atom_ok_of(active0, active1)
        actives = (active0, active1)

        def block_e(s):
            def pose_e(j):
                m = m0s[s] + j
                ra = evs[s].pose_atoms(com[m], quat[m])
                e_m, _ = evs[s].pair_energy(com[m], ra, coords, com,
                                            box, a_ok, m)
                return jnp.where(actives[s][j], e_m, 0.0)

            return jnp.sum(jax.vmap(pose_e)(jnp.arange(caps[s])))

        e = 0.5 * (block_e(0) + block_e(1))
        nf = tuple(jnp.sum(a.astype(dtype)) for a in actives)
        e = e + nf[0] * evs[0].self_intra(box) \
            + nf[1] * evs[1].self_intra(box)
        q_tot = nf[0] * evs[0].q_t_tot + nf[1] * evs[1].q_t_tot
        e = e + evs[0].wolf_const_coeff(box) * q_tot * q_tot
        if use_lrc:
            g = lrc_gmat(box)
            e = e + g[0, 0] * nf[0] * nf[0] + g[1, 1] * nf[1] * nf[1] \
                + 2.0 * g[0, 1] * nf[0] * nf[1]
        if use_ewald:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
            q_eff = jnp.where(a_ok, evs[0].charges_flat, 0.0)
            sf = ewald_ops.structure_factor(coords.T, q_eff, kv, box)
            e = e + ewald_ops.recip_energy(sf, cf)
        else:
            sf = jnp.zeros((K, 2), dtype)
        return e, sf

    def pose_lattice_init(key, box, n_chains):
        from metropolismontecarlo_tpu.io.configs import cubic_lattice
        lat = jnp.asarray(cubic_lattice(M, float(box)), dtype)
        com = jnp.broadcast_to(lat[None], (n_chains, M, 3))
        quat = random_quaternion(key, (n_chains, M), dtype) \
            if max(Ps) > 1 else \
            jnp.zeros((n_chains, M, 4), dtype).at[..., 0].set(1.0)
        ra0 = jax.vmap(jax.vmap(evs[0].pose_atoms))(
            com[:, m0_a:m1_a], quat[:, m0_a:m1_a])
        ra1 = jax.vmap(jax.vmap(evs[1].pose_atoms))(
            com[:, m0_b:m1_b], quat[:, m0_b:m1_b])
        flat = jnp.concatenate(
            [ra0.reshape(n_chains, caps[0] * P0, 3),
             ra1.reshape(n_chains, caps[1] * P1, 3)], 1)
        coords = jnp.swapaxes(flat, 1, 2)
        coords = jnp.pad(coords, ((0, 0), (0, 0), (0, A_pad - A)))
        return com, quat, coords

    return SimpleNamespace(
        evs=evs, caps=caps, m0s=m0s, a0s=a0s, Ps=Ps, M=M, A=A,
        A_pad=A_pad, K=K, kv=kv, kw=kw, use_ewald=use_ewald,
        atom_ok_of=atom_ok_of, write_pose=write_pose,
        exchange_const=exchange_const, pose_batch=pose_batch,
        full_one=full_one, pose_lattice_init=pose_lattice_init,
        trial_quats=trial_quats, rosenbluth=rosenbluth,
        use_lrc=use_lrc, lrc_gmat=lrc_gmat)


def make_gcmc_binary(system, params, activities, p_exchange=0.4,
                     dtype=jnp.float64, chunk=8, n_orient=1):
    """Build the binary-muVT step/energy functions.

    system: a System with EXACTLY two species blocks, each internally
    uniform; activities = (z0, z1).  Returns (init, run_steps,
    full_energy); full_energy(state) -> (energy (C,), sfac (C, K, 2)).
    Exchange attempts split px equally over the four exchange types
    (insert/delete x species).
    """
    ms = make_binary_slots(system, params, dtype)
    evs, caps, m0s, a0s, Ps = ms.evs, ms.caps, ms.m0s, ms.a0s, ms.Ps
    M, A, A_pad, K = ms.M, ms.A, ms.A_pad, ms.K
    kv, kw, use_ewald = ms.kv, ms.kw, ms.use_ewald
    m0_a, m0_b = m0s
    m1_a = m0_a + caps[0]
    m1_b = m0_b + caps[1]
    a0_a, a0_b = a0s
    P0, P1 = Ps
    atom_ok_of, write_pose = ms.atom_ok_of, ms.write_pose
    exchange_const, pose_batch = ms.exchange_const, ms.pose_batch
    trial_quats = ms.trial_quats

    beta = jnp.asarray(1.0 / params.temperature, dtype)
    zs = tuple(jnp.asarray(float(z), dtype) for z in activities)
    if len(zs) != 2:
        raise ValueError("activities must be a (z0, z1) pair")
    px = float(p_exchange)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    neg_inf = jnp.asarray(-jnp.inf, dtype)

    def _one_step(carry, _):
        (com, quat, coords, active0, active1, box, sfac, e, key,
         acc, att) = carry
        key, k = jax.random.split(key)
        (k_move, k_sel, k_pos, k_rot, k_ip0, k_ip1, k_iq0, k_iq1,
         k_ds0, k_ds1, k_dq0, k_dq1, k_pk0, k_pk1,
         k_acc) = jax.random.split(k, 15)
        actives = (active0, active1)
        ns = tuple(jnp.sum(a.astype(jnp.int32)) for a in actives)
        u_move = jax.random.uniform(k_move, dtype=dtype)
        # 0 disp, 1 rot, 2 insA, 3 delA, 4 insB, 5 delB
        q_x = 0.25 * px
        edges = np.cumsum([p_disp, p_rot, q_x, q_x, q_x])
        mt = jnp.searchsorted(jnp.asarray(edges, dtype), u_move,
                              side="right").astype(jnp.int32)
        a_ok = atom_ok_of(active0, active1)

        if use_ewald:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
        else:
            cf = None

        # --- displacement/rotation: pick among ALL active molecules ----
        active_all = jnp.concatenate(actives)          # (M,)
        n_tot = ns[0] + ns[1]
        u_sel = jax.random.uniform(k_sel, dtype=dtype)
        csum = jnp.cumsum(active_all.astype(jnp.int32))
        idx = jnp.argmax(csum >= jnp.floor(
            u_sel * n_tot.astype(dtype)).astype(jnp.int32) + 1)
        is_a = idx < caps[0]
        com_i, quat_i = com[idx], quat[idx]
        # statically skipped in exchange-only builds: four pair grids +
        # four structure-factor rows of pure waste when mt can never
        # select 0/1
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
                e_n, ovr_n = ev_s.pair_energy(com_new, ra_n, coords, com,
                                              box, a_ok, idx)
                if use_ewald:
                    s_o = ev_s.pose_sfac(ra_o, box)
                    s_n = ev_s.pose_sfac(ra_n, box)
                else:
                    s_o = s_n = jnp.zeros((K, 2), dtype)
                return ra_n, e_o, e_n, ovr_n, s_o, s_n

            raA_n, eA_o, eA_n, ovrA, sA_o, sA_n = species_pair(evs[0])
            raB_n, eB_o, eB_n, ovrB, sB_o, sB_n = species_pair(evs[1])
            e_old = jnp.where(is_a, eA_o, eB_o)
            e_new = jnp.where(is_a, eA_n, eB_n)
            ovr_new = jnp.where(is_a, ovrA, ovrB)
            s_old = jnp.where(is_a, sA_o, sB_o)
            s_new = jnp.where(is_a, sA_n, sB_n)
            d_move = ewald_ops.recip_energy_delta(sfac, s_new - s_old,
                                                  cf) \
                if use_ewald else jnp.zeros((), dtype)
            du_move = e_new - e_old + d_move

        # --- per-species insertion + deletion machinery ----------------
        k_ip, k_iq, k_pk = (k_ip0, k_ip1), (k_iq0, k_iq1), (k_pk0, k_pk1)
        k_ds, k_dq = (k_ds0, k_ds1), (k_dq0, k_dq1)
        ins, dele = [], []
        for s in (0, 1):
            cap_s = caps[s]
            nf_s = ns[s].astype(dtype)
            # insertion: k trial orientations at one uniform position
            com_ins = jax.random.uniform(k_ip[s], (3,), dtype) * box
            quats_i = trial_quats[s](k_iq[s], n_or)
            u_i, ovr_i, s_i = pose_batch(s, com_ins, quats_i, coords,
                                         com, box, a_ok, -1, sfac, cf)
            slot = jnp.argmax(~actives[s])
            full = ns[s] >= cap_s
            m_i, w_i = rosenbluth(jnp.where(ovr_i, neg_inf,
                                            -beta * u_i))
            w_sum_i = jnp.sum(w_i)
            u_pick = jax.random.uniform(k_pk[s], dtype=dtype)
            j_sel = jnp.argmax(jnp.cumsum(w_i) > u_pick * w_sum_i)
            quat_ins = quats_i[j_sel]
            ra_ins = evs[s].pose_atoms(com_ins, quat_ins)
            ec_ins = exchange_const(box, ns[0], ns[1], s, +1.0)
            ins.append(dict(
                com=com_ins, quat=quat_ins, ra=ra_ins, sfac=s_i[j_sel],
                slot=slot, full=full, m=m_i, w_sum=w_sum_i, ec=ec_ins,
                du=u_i[j_sel] + ec_ins, nf=nf_s))
            # deletion: existing orientation + k-1 fresh trials
            u_sd = jax.random.uniform(k_ds[s], dtype=dtype)
            csum_s = jnp.cumsum(actives[s].astype(jnp.int32))
            slot_del = jnp.argmax(csum_s >= jnp.floor(u_sd * nf_s)
                                  .astype(jnp.int32) + 1)
            mol_d = m0s[s] + slot_del
            com_d, quat_d = com[mol_d], quat[mol_d]
            ra_d = evs[s].pose_atoms(com_d, quat_d)
            e_d, _ = evs[s].pair_energy(com_d, ra_d, coords, com, box,
                                        a_ok, mol_d)
            if use_ewald:
                s_d = evs[s].pose_sfac(ra_d, box)
                sfac_wo = sfac - s_d
                u_exist = e_d + ewald_ops.recip_energy_delta(sfac_wo,
                                                             s_d, cf)
            else:
                s_d = jnp.zeros((K, 2), dtype)
                sfac_wo = sfac
                u_exist = e_d
            if n_or > 1:
                quats_d = trial_quats[s](k_dq[s], n_or - 1)
                u_dd, ovr_dd, _ = pose_batch(s, com_d, quats_d, coords,
                                             com, box, a_ok, mol_d,
                                             sfac_wo, cf)
                neg_d = jnp.concatenate([(-beta * u_exist)[None],
                                         jnp.where(ovr_dd, neg_inf,
                                                   -beta * u_dd)])
            else:
                neg_d = (-beta * u_exist)[None]
            m_d, w_d = rosenbluth(neg_d)
            ec_del = exchange_const(box, ns[0], ns[1], s, -1.0)
            dele.append(dict(
                slot=slot_del, sfac=s_d, m=m_d, w_sum=jnp.sum(w_d),
                ec=ec_del, du=-u_exist + ec_del, nf=nf_s))

        # --- acceptance -------------------------------------------------
        vol = box**3
        u = jax.random.uniform(k_acc, dtype=dtype)
        ln_u = jnp.log(jnp.maximum(u, jnp.asarray(1e-300, dtype)))
        if move_on:
            ok_m = (mt <= 1) & (n_tot > 0) & ~ovr_new \
                & (u < jnp.exp(-beta * du_move))
        else:
            ok_m = jnp.asarray(False)
        ok_i, ok_d = [], []
        for s in (0, 1):
            i_s, d_s = ins[s], dele[s]
            ln_acc_i = jnp.log(zs[s] * vol / (i_s["nf"] + 1.0)) \
                + i_s["m"] + jnp.log(jnp.maximum(i_s["w_sum"], 1e-300)) \
                - float(np.log(n_or)) - beta * i_s["ec"]
            ok_i.append((mt == 2 + 2 * s) & ~i_s["full"]
                        & (i_s["w_sum"] > 0.0) & (ln_u < ln_acc_i))
            ln_acc_d = jnp.log(jnp.maximum(d_s["nf"], 1.0)
                               / (zs[s] * vol)) + float(np.log(n_or)) \
                - d_s["m"] - jnp.log(jnp.maximum(d_s["w_sum"], 1e-300)) \
                - beta * d_s["ec"]
            ok_d.append((mt == 3 + 2 * s) & (ns[s] > 0)
                        & (ln_u < ln_acc_d))

        # --- apply ------------------------------------------------------
        if move_on:
            com = com.at[idx].set(jnp.where(ok_m, com_new, com[idx]))
            quat = quat.at[idx].set(jnp.where(ok_m, quat_new, quat[idx]))
            a0_mA = jnp.where(is_a, a0_a + (idx - m0_a) * P0, 0)
            coords = write_pose(coords, a0_mA, P0, raA_n, ok_m & is_a)
            a0_mB = jnp.where(is_a, 0, a0_b + (idx - m0_b) * P1)
            coords = write_pose(coords, a0_mB, P1, raB_n, ok_m & ~is_a)
        new_actives = []
        for s in (0, 1):
            i_s, d_s = ins[s], dele[s]
            mol_i = m0s[s] + i_s["slot"]
            com = com.at[mol_i].set(jnp.where(ok_i[s], i_s["com"],
                                              com[mol_i]))
            quat = quat.at[mol_i].set(jnp.where(ok_i[s], i_s["quat"],
                                                quat[mol_i]))
            coords = write_pose(coords, a0s[s] + i_s["slot"] * Ps[s],
                                Ps[s], i_s["ra"], ok_i[s])
            # one-hot where-selects, never bool scatters
            # (utils/activity.py: the bool-scatter hazard)
            act = set_slot(actives[s], i_s["slot"], ok_i[s])
            act = clear_slot(act, d_s["slot"], ok_d[s])
            new_actives.append(act)
            sfac = sfac + jnp.where(ok_i[s], 1.0, 0.0) * i_s["sfac"] \
                - jnp.where(ok_d[s], 1.0, 0.0) * d_s["sfac"]
            e = e + jnp.where(ok_i[s], i_s["du"], 0.0) \
                + jnp.where(ok_d[s], d_s["du"], 0.0)
        if move_on:
            sfac = sfac + jnp.where(ok_m, 1.0, 0.0) * (s_new - s_old)
            e = e + jnp.where(ok_m, du_move, 0.0)
        a_row = jnp.stack([ok_m & (mt == 0), ok_m & (mt == 1),
                           ok_i[0], ok_d[0], ok_i[1], ok_d[1]]) \
            .astype(jnp.int32)
        t_row = (jnp.arange(6) == mt).astype(jnp.int32)
        carry = (com, quat, coords, new_actives[0], new_actives[1],
                 box, sfac, e, key, acc + a_row, att + t_row)
        return carry, None

    def _run_chain(com, quat, coords, active0, active1, box, sfac, e,
                   key, acc, att, n_steps):
        carry = (com, quat, coords, active0, active1, box, sfac, e,
                 key, acc, att)
        carry, _ = jax.lax.scan(_one_step, carry, None, length=n_steps)
        return carry

    @jax.jit
    def full_energy(state):
        return chunked_vmap(ms.full_one, chunk, state.com, state.quat,
                            state.coords, state.active0, state.active1,
                            state.box)

    @partial(jax.jit, static_argnums=1)
    def run_steps(state, n_steps):
        out = jax.vmap(_run_chain, in_axes=(0,) * 11 + (None,))(
            state.com, state.quat, state.coords, state.active0,
            state.active1, state.box, state.sfac, state.energy,
            state.key, state.acc, state.att, n_steps)
        return BinaryGCMCState(*out)

    def init(key, box, n_init, n_chains):
        """Lattice placement of ALL M slots; n_init = (n0, n1) — the
        first n_s slots of each species block start active."""
        n0, n1 = int(n_init[0]), int(n_init[1])
        if n0 > caps[0] or n1 > caps[1]:
            raise ValueError(f"n_init {n_init} exceeds capacities "
                             f"{caps}")
        if params.strict_min_image and box < 2.0 * max(params.r_cut,
                                                       params.qq_cut):
            raise ValueError(f"box {box} < 2*cutoff violates minimum-"
                             "image (set strict_min_image=False to "
                             "sample the truncated model)")
        k_chain, k_quat = jax.random.split(jnp.asarray(key))
        keys = jax.random.split(k_chain, n_chains)
        com, quat, coords = ms.pose_lattice_init(k_quat, box, n_chains)
        state = BinaryGCMCState(
            com=com, quat=quat, coords=coords,
            active0=jnp.broadcast_to(jnp.arange(caps[0]) < n0,
                                     (n_chains, caps[0])),
            active1=jnp.broadcast_to(jnp.arange(caps[1]) < n1,
                                     (n_chains, caps[1])),
            box=jnp.full((n_chains,), box, dtype),
            sfac=jnp.zeros((n_chains, K, 2), dtype),
            energy=jnp.zeros((n_chains,), dtype), key=keys,
            acc=jnp.zeros((n_chains, 6), jnp.int32),
            att=jnp.zeros((n_chains, 6), jnp.int32))
        e, sf = full_energy(state)
        return state._replace(energy=e, sfac=sf)

    return init, run_steps, full_energy


class BinaryGCMC:
    """Driver wrapper: blocks with the drift invariant and per-species
    N statistics (means, variances, N0-N1 covariance for composition
    fluctuations).

    >>> g = BinaryGCMC(two_block_system, params, activities=(z0, z1))
    >>> st = g.init(key, box=10.0, n_init=(8, 8), n_chains=64)
    >>> st, stats = g.run_block(st, 2000, drift_tol=1e-9)
    """

    def __init__(self, system, params, activities, p_exchange=0.4,
                 dtype=jnp.float64, chunk=8, n_orient=1):
        self.params = params
        self._init, self.run_steps, self.full_energy = make_gcmc_binary(
            system, params, activities, p_exchange, dtype, chunk,
            n_orient)
        sl = system.species_slices
        self.capacities = (sl[0][2] - sl[0][1], sl[1][2] - sl[1][1])
        self._system = system

    def init(self, key, box, n_init, n_chains):
        return self._init(key, box, n_init, n_chains)

    def atom_mask(self, state):
        """(C, A_pad) per-atom activity mask for the masked RDF/S(k)."""
        sl = self._system.species_slices
        moa = np.asarray(self._system.mol_of_atom_padded)
        real = moa >= 0
        col_b = (moa >= sl[1][1]) & real
        slot0 = jnp.asarray(np.clip(moa - sl[0][1], 0,
                                    self.capacities[0] - 1))
        slot1 = jnp.asarray(np.clip(moa - sl[1][1], 0,
                                    self.capacities[1] - 1))
        return jnp.asarray(real)[None, :] & jnp.where(
            jnp.asarray(col_b)[None, :], state.active1[:, slot1],
            state.active0[:, slot0])

    def run_block(self, state, n_steps, drift_tol=None):
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        e, sf = self.full_energy(state)
        # both-endpoint drift scale (see mc/gcmc_mol.MolGCMC.run_block)
        scale = jnp.maximum(jnp.maximum(jnp.abs(e), jnp.abs(e_start)), 1.0)
        drift = jnp.max(jnp.abs(e - state.energy) / scale)
        sfac_err = jnp.max(jnp.abs(sf - state.sfac))
        n0 = jnp.sum(state.active0, axis=1).astype(jnp.float64)
        n1 = jnp.sum(state.active1, axis=1).astype(jnp.float64)
        ratio = (state.acc - acc0) / jnp.maximum(state.att - att0, 1)
        stats = {
            "n0_mean": float(jnp.mean(n0)),
            "n1_mean": float(jnp.mean(n1)),
            "n0_var": float(jnp.var(n0)),
            "n1_var": float(jnp.var(n1)),
            "cov01": float(jnp.mean((n0 - jnp.mean(n0))
                                    * (n1 - jnp.mean(n1)))),
            "full_frac0": float(jnp.mean(
                (n0 >= self.capacities[0]).astype(jnp.float64))),
            "full_frac1": float(jnp.mean(
                (n1 >= self.capacities[1]).astype(jnp.float64))),
            "energy_mean": float(jnp.mean(e)),
            "acc_trans": float(jnp.mean(ratio[:, 0])),
            "acc_rot": float(jnp.mean(ratio[:, 1])),
            "acc_insert0": float(jnp.mean(ratio[:, 2])),
            "acc_delete0": float(jnp.mean(ratio[:, 3])),
            "acc_insert1": float(jnp.mean(ratio[:, 4])),
            "acc_delete1": float(jnp.mean(ratio[:, 5])),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None:
            assert stats["drift_max_rel"] < drift_tol, stats
            assert not np.isnan(stats["energy_mean"]), stats
        return state._replace(energy=e, sfac=sf), stats
