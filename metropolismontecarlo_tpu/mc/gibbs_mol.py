"""Gibbs-ensemble MC for rigid molecular species: two-box coexistence
with orientational transfers and full electrostatics.

The molecular extension of `mc/gibbs.py` (Panagiotopoulos 1987; Frenkel
& Smit ch. 8), built on the same slot machinery as the molecular muVT
app (`mc/gcmc_mol.py:make_mol_slots` — the Widom pose evaluator with
activity masks, carried per-box Ewald structure factors, and the
box-dependent per-molecule self+intra constants).  Moves:

    displace / rotate (within the non-transfer budget, split by
        params.p_translate):  standard Metropolis in a random box;
    volume   (every round(1/p_volume) steps, deterministic cycle as in
        mc/npt.py — see mc/gibbs.py for why not per-step Bernoulli):
        dV transfer, COMs rescaled with orientations fixed, BOTH boxes
        fully recomputed (energies AND structure factors; kappa =
        kappa_L/box changes with each box),
        min[1, (V1'/V1)^N1 (V2'/V2)^N2 exp(-beta dU_total)];
    transfer: remove a uniform-random molecule from box s, insert into
        box d at a uniform position and uniform orientation,
        min[1, N_s V_d / ((N_d + 1) V_s) exp(-beta dU)]
        where dU includes both boxes' pair + reciprocal deltas and the
        self+intra constant difference const(box_d) - const(box_s)
        (the constants do NOT cancel between different-sized boxes).

Exactness anchors (tests/test_gibbs_mol.py): ideal rigid rotor
Binomial(N, 1/2) partitioning; interacting-triatomic density AND
chemical-potential equality between boxes (supercritical, so both boxes
sample one phase — the equalities are the ensemble's defining fixed
point); SPC/E water Ewald drift + structure-factor drift through
transfers and volume exchanges.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.mc.gcmc_mol import make_mol_slots
from metropolismontecarlo_tpu.ops import ewald as ewald_ops
from metropolismontecarlo_tpu.ops.quaternions import random_rotate_quaternion
from metropolismontecarlo_tpu.utils.activity import clear_slot2, set_slot2
from metropolismontecarlo_tpu.utils.chunking import chunked_vmap


class MolGibbsState(NamedTuple):
    com: jnp.ndarray      # (C, 2, cap, 3)
    quat: jnp.ndarray     # (C, 2, cap, 4)
    coords: jnp.ndarray   # (C, 2, 3, A_pad)
    active: jnp.ndarray   # (C, 2, cap) bool
    box: jnp.ndarray      # (C, 2)
    sfac: jnp.ndarray     # (C, 2, K, 2)
    energy: jnp.ndarray   # (C, 2)
    key: jnp.ndarray      # (C, 2) PRNG keys
    acc: jnp.ndarray      # (C, 4) accepted [disp, rot, vol, transfer]
    att: jnp.ndarray      # (C, 4)


def make_gibbs_mol(system, params, dv_max=0.05, p_transfer=0.3,
                   dtype=jnp.float64, n_orient=1, chunk=8):
    """Build the molecular Gibbs-ensemble step/energy functions.

    system: uniform single-species System; its n_mol is the PER-BOX slot
    capacity.  dv_max: volume-transfer half-width as a fraction of the
    total volume.  Returns (init, run_steps, full_energy,
    widom_boltzmann, check_ewald_consistency, pressure_fd).

    n_orient > 1 enables orientational-bias transfers (Rosenbluth
    k-trial insertion in the destination box, existing orientation +
    k-1 trials at the molecule's COM in the source box; see
    mc/gcmc_mol.py).  Exact for every k; k = 1 is the unbiased rule.
    """
    ms = make_mol_slots(system, params, dtype)
    ev, P, cap, K = ms.ev, ms.P, ms.cap, ms.K
    use_ewald = ms.use_ewald

    beta = jnp.asarray(1.0 / params.temperature, dtype)
    p_v = float(params.p_volume)
    px = float(p_transfer)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    neg_inf = jnp.asarray(-jnp.inf, dtype)
    # conditional split of the cheap-step budget (volume rides its own
    # deterministic cycle): transfer px, rest disp/rot by p_translate
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    wall = 2.0 * max(params.r_cut, params.qq_cut) \
        if params.strict_min_image else 0.0

    def check_ewald_consistency(boxes, tol=5e-3):
        """Transfers require BOTH boxes to sample the SAME model, which
        for Ewald means both truncation tails must be CONVERGED — a
        merely self-consistent truncated model is box-dependent under
        the kappa = kappa_L/box convention (erfc(kappa r_cut) differs
        between boxes), and molecules then drain into whichever box's
        mangled electrostatics are more favorable.  MEASURED: the
        reference convention kappa_L = 5.6, nk = 5 with r_cut 5.5 gives
        erfc(kappa r_cut) = 0.05 in a 22 A box, and supercritical water
        in (14, 22) boxes splits to a 15x density ratio instead of
        equalizing; with tuned parameters it equalizes.  Fix with
        ops.ewald.tune_parameters(max_box, r_cut, tol)."""
        if not use_ewald:
            return
        from scipy.special import erfc as _herfc
        worst = float(np.max(_herfc(
            params.kappa_L / np.asarray(boxes, np.float64)
            * params.qq_cut)))
        if worst > tol:
            big = float(np.max(boxes))
            raise ValueError(
                f"Ewald real-space truncation erfc(kappa*qq_cut) = "
                f"{worst:.2e} in the {big:.1f} A box exceeds {tol:g}: "
                "the two boxes would sample DIFFERENT truncated models "
                "and transfers drain into the softer one.  Set kappa_L/"
                "nk/ksq_max from ops.ewald.tune_parameters(max_box, "
                "r_cut, tol) for the largest box this run can reach")

    def pose_sfac_or_zero(ra, box):
        if use_ewald:
            return ev.pose_sfac(ra, box)
        return jnp.zeros((K, 2), dtype)

    def recip_delta(sfac_b, ds, box):
        if not use_ewald:
            return jnp.zeros((), dtype)
        kappa = jnp.asarray(params.kappa_L, dtype) / box
        cf = ewald_ops.cfac_coeffs(ms.kv, ms.kw, kappa, box, dtype)
        return ewald_ops.recip_energy_delta(sfac_b, ds, cf)

    def _cheap_step(carry, _):
        com, quat, coords, active, box, sfac, e, key, acc, att = carry
        key, k = jax.random.split(key)
        (k_move, k_box, k_sel, k_pos, k_rot, k_insq, k_delq, k_pick,
         k_acc) = jax.random.split(k, 9)
        n = jnp.sum(active.astype(jnp.int32), axis=1)          # (2,)
        nf = n.astype(dtype)
        v = box**3
        u_move = jax.random.uniform(k_move, dtype=dtype)
        # 0 displace, 1 rotate, 3 transfer (2 = volume, cycle-scheduled)
        mt = jnp.where(u_move < p_disp, 0,
                       jnp.where(u_move < p_disp + p_rot, 1, 3))
        u = jax.random.uniform(k_acc, dtype=dtype)
        u_sel = jax.random.uniform(k_sel, dtype=dtype)
        b = jax.random.bernoulli(k_box).astype(jnp.int32)      # box pick

        # --- shared slot pick among box b's actives ---------------------
        csum = jnp.cumsum(active[b].astype(jnp.int32))
        idx = jnp.argmax(csum >= jnp.floor(u_sel * nf[b])
                         .astype(jnp.int32) + 1)
        a_ok_b = ms.atom_ok_of(active[b])
        com_i, quat_i = com[b, idx], quat[b, idx]
        ra_old = ev.pose_atoms(com_i, quat_i)
        e_old, _ = ev.pair_energy(com_i, ra_old, coords[b], com[b],
                                  box[b], a_ok_b, idx)
        s_old = pose_sfac_or_zero(ra_old, box[b])

        # --- displaced / rotated pose in box b (statically skipped in
        # transfer-only builds; e_old/ra_old/s_old stay: the transfer
        # source needs them) ---------------------------------------------
        move_on = p_disp + p_rot > 0.0
        if move_on:
            disp = (jax.random.uniform(k_pos, (3,), dtype) - 0.5) \
                * params.dr_max
            com_new = jnp.where(mt == 0, (com_i + disp) % box[b], com_i)
            quat_new = jnp.where(mt == 1,
                                 random_rotate_quaternion(
                                     k_rot, quat_i, params.dphi_max),
                                 quat_i)
            ra_new = ev.pose_atoms(com_new, quat_new)
            e_new, ovr_new = ev.pair_energy(com_new, ra_new, coords[b],
                                            com[b], box[b], a_ok_b, idx)
            s_new = pose_sfac_or_zero(ra_new, box[b])
            du_move = e_new - e_old + recip_delta(sfac[b], s_new - s_old,
                                                  box[b])
            ok_m = (mt <= 1) & (n[b] > 0) & ~ovr_new \
                & (u < jnp.exp(-beta * du_move))
        else:
            ok_m = jnp.asarray(False)

        # --- transfer s -> d (s = b, same random bit) -------------------
        # Rosenbluth orientational bias: n_or trials in the destination,
        # existing orientation + n_or-1 trials in the source (n_or = 1
        # reduces to the unbiased rule); see mc/gcmc_mol.py for the
        # acceptance algebra (the ln k terms cancel between the boxes)
        s_box, d_box = b, 1 - b
        if use_ewald:
            kap = jnp.asarray(params.kappa_L, dtype) / box
            cf_s = ewald_ops.cfac_coeffs(ms.kv, ms.kw, kap[s_box],
                                         box[s_box], dtype)
            cf_d = ewald_ops.cfac_coeffs(ms.kv, ms.kw, kap[d_box],
                                         box[d_box], dtype)
        else:
            cf_s = cf_d = None
        pos_d = jax.random.uniform(k_pos, (3,), dtype) * box[d_box]
        quats_in = ms.trial_quats(k_insq, n_or)
        u_in_j, ovr_in_j, s_in_j = ms.pose_batch(
            pos_d, quats_in, coords[d_box], com[d_box], box[d_box],
            ms.atom_ok_of(active[d_box]), -1, sfac[d_box], cf_d)
        m_n, w_n = ms.rosenbluth(jnp.where(ovr_in_j, neg_inf,
                                           -beta * u_in_j))
        w_sum_n = jnp.sum(w_n)
        u_pick = jax.random.uniform(k_pick, dtype=dtype)
        j_sel = jnp.argmax(jnp.cumsum(w_n) > u_pick * w_sum_n)
        quat_d = quats_in[j_sel]
        ra_in = ev.pose_atoms(pos_d, quat_d)
        s_in = s_in_j[j_sel]
        slot_d = jnp.argmax(~active[d_box])

        sfac_wo = sfac[s_box] - s_old if use_ewald else sfac[s_box]
        if use_ewald:
            u_exist = e_old + ewald_ops.recip_energy_delta(sfac_wo, s_old,
                                                           cf_s)
        else:
            u_exist = e_old
        if n_or > 1:
            quats_del = ms.trial_quats(k_delq, n_or - 1)
            u_o_j, ovr_o_j, _ = ms.pose_batch(
                com_i, quats_del, coords[s_box], com[s_box], box[s_box],
                a_ok_b, idx, sfac_wo, cf_s)
            neg_o = jnp.concatenate([(-beta * u_exist)[None],
                                     jnp.where(ovr_o_j, neg_inf,
                                               -beta * u_o_j)])
        else:
            neg_o = (-beta * u_exist)[None]
        m_o, w_o = ms.rosenbluth(neg_o)
        w_sum_o = jnp.sum(w_o)

        ec_d = ms.exchange_const(box[d_box], n[d_box], +1.0)
        ec_s = ms.exchange_const(box[s_box], n[s_box], -1.0)
        du_d = u_in_j[j_sel] + ec_d
        du_s = -u_exist + ec_s
        ln_u = jnp.log(jnp.maximum(u, jnp.asarray(1e-300, dtype)))
        ln_acc_x = jnp.log(jnp.maximum(nf[s_box], 1.0) * v[d_box]
                           / ((nf[d_box] + 1.0) * v[s_box])) \
            + m_n + jnp.log(jnp.maximum(w_sum_n, 1e-300)) \
            - m_o - jnp.log(jnp.maximum(w_sum_o, 1e-300)) \
            - beta * (ec_d + ec_s)
        ok_x = (mt == 3) & (n[s_box] > 0) & (n[d_box] < cap) \
            & (w_sum_n > 0.0) & (ln_u < ln_acc_x)

        # --- apply (mutually exclusive branches) ------------------------
        if move_on:
            com = com.at[b, idx].set(jnp.where(ok_m, com_new,
                                               com[b, idx]))
            quat = quat.at[b, idx].set(jnp.where(ok_m, quat_new,
                                                 quat[b, idx]))
            coords = coords.at[b].set(
                ms.write_pose(coords[b], idx, ra_new, ok_m))
        com = com.at[d_box, slot_d].set(
            jnp.where(ok_x, pos_d, com[d_box, slot_d]))
        quat = quat.at[d_box, slot_d].set(
            jnp.where(ok_x, quat_d, quat[d_box, slot_d]))
        coords = coords.at[d_box].set(
            ms.write_pose(coords[d_box], slot_d, ra_in, ok_x))
        # one-hot where-selects, never bool scatters (utils/activity.py:
        # the bool-scatter hazard)
        active = set_slot2(active, d_box, slot_d, ok_x)
        active = clear_slot2(active, s_box, idx, ok_x)
        w_x = jnp.where(ok_x, 1.0, 0.0)
        if move_on:
            w_m = jnp.where(ok_m, 1.0, 0.0)
            sfac = sfac.at[b].add(w_m * (s_new - s_old))
            e = e.at[b].add(jnp.where(ok_m, du_move, 0.0))
        sfac = sfac.at[s_box].add(-w_x * s_old)
        sfac = sfac.at[d_box].add(w_x * s_in)
        e = e.at[s_box].add(jnp.where(ok_x, du_s, 0.0))
        e = e.at[d_box].add(jnp.where(ok_x, du_d, 0.0))
        a_row = jnp.stack([ok_m & (mt == 0), ok_m & (mt == 1),
                           jnp.zeros((), bool), ok_x]).astype(jnp.int32)
        t_row = (jnp.arange(4) == mt).astype(jnp.int32)
        carry = (com, quat, coords, active, box, sfac, e, key,
                 acc + a_row, att + t_row)
        return carry, None

    def rebuild_two(com_v, quat):
        """(2, 3, A_pad) atom planes for both boxes from slot poses."""
        ra_v = jax.vmap(ev.pose_atoms)(com_v.reshape(2 * cap, 3),
                                       quat.reshape(2 * cap, 4))
        coords_v = jnp.swapaxes(
            ra_v.reshape(2, cap * P, 3), 1, 2)        # (2, 3, A)
        pad = ms.A_pad - ms.A
        if pad:
            coords_v = jnp.pad(coords_v, ((0, 0), (0, 0), (0, pad)))
        return coords_v

    def _vol_step(carry):
        """Volume transfer: rescale COMs (orientations fixed), rebuild
        atoms, dense recompute of BOTH boxes (energy + sfac)."""
        com, quat, coords, active, box, sfac, e, key, acc, att = carry
        key, k = jax.random.split(key)
        k_pos, k_acc = jax.random.split(k)
        n = jnp.sum(active.astype(jnp.int32), axis=1)
        nf = n.astype(dtype)
        v = box**3
        dv = (jax.random.uniform(k_pos, dtype=dtype) - 0.5) * 2.0 \
            * dv_max * jnp.sum(v)
        v_new = v + jnp.stack([dv, -dv])
        box_new = jnp.cbrt(v_new)
        legal = jnp.all(box_new > wall) & jnp.all(v_new > 0.0)
        box_t = jnp.where(legal, box_new, box)
        scale = jnp.where(legal, box_new / box, 1.0)
        com_v = com * scale[:, None, None]
        coords_v = rebuild_two(com_v, quat)
        e_v, sf_v = jax.vmap(ms.full_one)(com_v, quat, coords_v, active,
                                          box_t)
        log_a = jnp.sum(nf * jnp.log(jnp.where(legal, v_new / v, 1.0))) \
            - beta * jnp.sum(e_v - e)
        u = jax.random.uniform(k_acc, dtype=dtype)
        ok_v = legal & (jnp.log(jnp.maximum(u, 1e-300)) < log_a)

        wv = jnp.where(ok_v, 1.0, 0.0)
        com = jnp.where(ok_v, com_v, com)
        coords = jnp.where(ok_v, coords_v, coords)
        box = jnp.where(ok_v, box_new, box)
        sfac = sfac + wv * (sf_v - sfac)
        e = jnp.where(ok_v, e_v, e)
        acc = acc.at[2].add(ok_v.astype(jnp.int32))
        att = att.at[2].add(1)
        return (com, quat, coords, active, box, sfac, e, key, acc, att)

    period = int(round(1.0 / p_v)) if p_v > 0 else 0

    def _run_chain(com, quat, coords, active, box, sfac, e, key, acc, att,
                   n_steps):
        carry = (com, quat, coords, active, box, sfac, e, key, acc, att)
        if period > 0:
            n_cycles, rem = divmod(n_steps, period)

            def cycle(c, _):
                c, _ = jax.lax.scan(_cheap_step, c, None,
                                    length=period - 1)
                return _vol_step(c), None

            if n_cycles:
                carry, _ = jax.lax.scan(cycle, carry, None,
                                        length=n_cycles)
        else:
            rem = n_steps
        if rem:
            carry, _ = jax.lax.scan(_cheap_step, carry, None, length=rem)
        return carry

    @jax.jit
    def full_energy(state):
        def both(com, quat, coords, active, box):
            return jax.vmap(ms.full_one)(com, quat, coords, active, box)

        # chunked over chains like the muVT app: each chain holds TWO
        # (cap, P, A_pad) pair grids during the dense recompute
        return chunked_vmap(both, chunk, state.com, state.quat,
                            state.coords, state.active, state.box)

    @partial(jax.jit, static_argnums=1)
    def run_steps(state, n_steps):
        out = jax.vmap(_run_chain, in_axes=(0,) * 10 + (None,))(
            state.com, state.quat, state.coords, state.active, state.box,
            state.sfac, state.energy, state.key, state.acc, state.att,
            n_steps)
        return MolGibbsState(*out)

    def init(key, boxes, n_init, n_chains):
        """boxes (2,) edge lengths; n_init (2,) active molecules per box."""
        n_init = np.asarray(n_init, np.int64)
        if np.any(n_init > cap):
            raise ValueError("n_init exceeds capacity")
        if params.strict_min_image and min(boxes) < wall:
            raise ValueError(
                f"box {min(boxes)} < 2*cutoff ({wall}) violates minimum-"
                "image (set strict_min_image=False to sample the "
                "truncated model); the volume move only walls PROPOSED "
                "boxes, so an illegal start would go uncaught")
        check_ewald_consistency(np.asarray(boxes))
        k_chain, k1, k2 = jax.random.split(jnp.asarray(key), 3)
        keys = jax.random.split(k_chain, n_chains)
        per_box = [ms.pose_lattice_init(kk, float(b), n_chains)
                   for kk, b in zip((k1, k2), np.asarray(boxes))]
        com = jnp.stack([p[0] for p in per_box], axis=1)
        quat = jnp.stack([p[1] for p in per_box], axis=1)
        coords = jnp.stack([p[2] for p in per_box], axis=1)
        active = jnp.broadcast_to(
            jnp.arange(cap)[None, :] < jnp.asarray(n_init)[:, None],
            (n_chains, 2, cap))
        state = MolGibbsState(
            com=com, quat=quat, coords=coords, active=active,
            box=jnp.broadcast_to(jnp.asarray(boxes, dtype),
                                 (n_chains, 2)),
            sfac=jnp.zeros((n_chains, 2, K, 2), dtype),
            energy=jnp.zeros((n_chains, 2), dtype), key=keys,
            acc=jnp.zeros((n_chains, 4), jnp.int32),
            att=jnp.zeros((n_chains, 4), jnp.int32))
        e, sf = full_energy(state)
        return state._replace(energy=e, sfac=sf)

    # per-box molecular Widom insertions for the mu-equality diagnostic
    @partial(jax.jit, static_argnums=2)
    def widom_boltzmann(state, key, n_insertions):
        """(C, 2) mean exp(-beta dU_test) per box, dU with the full
        exchange energetics (pair + reciprocal + self/intra constants) —
        so -ln of it is beta mu_ex in the SAME convention for both
        boxes, and equality is the coexistence diagnostic."""
        def one(com, quat, coords, active, box, sfac, k):
            kp, kq = jax.random.split(k)
            pos = jax.random.uniform(kp, (n_insertions, 3), dtype) * box
            quats = ms.trial_quats(kq, n_insertions)
            n = jnp.sum(active.astype(jnp.int32))
            a_ok = ms.atom_ok_of(active)

            def du_one(p, q):
                ra = ev.pose_atoms(p, q)
                e_p, ovr = ev.pair_energy(p, ra, coords, com, box, a_ok,
                                          -1)
                du = e_p + recip_delta(sfac, pose_sfac_or_zero(ra, box),
                                       box) \
                    + ms.exchange_const(box, n, +1.0)
                return jnp.where(ovr, 0.0, jnp.exp(-beta * du))

            return jnp.mean(jax.vmap(du_one)(pos, quats))

        C = state.com.shape[0]
        ks = jax.random.split(jnp.asarray(key), C * 2).reshape(C, 2, 2)
        return jax.vmap(jax.vmap(one))(state.com, state.quat,
                                       state.coords, state.active,
                                       state.box, state.sfac, ks)

    @partial(jax.jit, static_argnums=(2, 3))
    def widom_works(state, key, n_insert, n_delete):
        """Raw per-box exchange works for a TWO-SIDED (BAR) chemical
        potential: ghost-insertion energies du_ins (C, 2, n_insert)
        with overlap flags, and real-molecule deletion energy changes
        du_del (C, 2, n_delete) (the energy change of REMOVING a
        uniformly picked active molecule, = -u_exist + const).  Both
        carry the full exchange energetics (pair + reciprocal +
        box-dependent self/intra constants), so
        `mc/fep.bar_mu_ex(du_ins, ovr, -du_del - 2*const...)` — see
        docs/validation/run_gibbs_water.py — estimates beta*mu_ex per
        box WITHOUT the one-sided Widom fat-tail bias that dominates in
        the dense liquid."""
        def one(com, quat, coords, active, box, sfac, k):
            kp, kq, kd = jax.random.split(k, 3)
            n = jnp.sum(active.astype(jnp.int32))
            nf = n.astype(dtype)
            a_ok = ms.atom_ok_of(active)
            pos = jax.random.uniform(kp, (n_insert, 3), dtype) * box
            quats = ms.trial_quats(kq, n_insert)
            ec_i = ms.exchange_const(box, n, +1.0)
            ec_d = ms.exchange_const(box, n, -1.0)

            def ins_one(p, q):
                ra = ev.pose_atoms(p, q)
                e_p, ovr = ev.pair_energy(p, ra, coords, com, box, a_ok,
                                          -1)
                du = e_p + recip_delta(sfac, pose_sfac_or_zero(ra, box),
                                       box) + ec_i
                return du, ovr

            du_i, ovr_i = jax.vmap(ins_one)(pos, quats)

            def del_one(u_sel):
                csum = jnp.cumsum(active.astype(jnp.int32))
                idx = jnp.argmax(csum >= jnp.floor(u_sel * nf)
                                 .astype(jnp.int32) + 1)
                ra = ev.pose_atoms(com[idx], quat[idx])
                e_d, _ = ev.pair_energy(com[idx], ra, coords, com, box,
                                        a_ok, idx)
                s_d = pose_sfac_or_zero(ra, box)
                u_exist = e_d + recip_delta(sfac - s_d, s_d, box)
                return -u_exist + ec_d

            us = jax.random.uniform(kd, (n_delete,), dtype)
            return du_i, ovr_i, jax.vmap(del_one)(us)

        C = state.com.shape[0]
        ks = jax.random.split(jnp.asarray(key), C * 2).reshape(C, 2, 2)
        return jax.vmap(jax.vmap(one))(state.com, state.quat,
                                       state.coords, state.active,
                                       state.box, state.sfac, ks)

    @jax.jit
    def pressure_fd(state, rel=1e-4):
        """(C, 2) exact pressure per box, K/A^3: P = N k T / V - dU/dV
        by central FD on the COM-rescaled rigid-molecule energy (the
        NPT driver's exact route per Gibbs box; the two boxes must
        agree at coexistence and the vapor box's value is the
        saturation pressure of the sampled model)."""
        def one_chain(com, quat, active, box):
            v = box**3

            def e_at(s):
                com_s = com * s[:, None, None]
                coords_s = rebuild_two(com_s, quat)
                e, _ = jax.vmap(ms.full_one)(com_s, quat, coords_s,
                                             active, box * s)
                return e

            s_hi = jnp.full((2,), (1.0 + rel) ** (1.0 / 3.0), dtype)
            s_lo = jnp.full((2,), (1.0 - rel) ** (1.0 / 3.0), dtype)
            dudv = (e_at(s_hi) - e_at(s_lo)) / (2.0 * rel * v)
            nf = jnp.sum(active.astype(dtype), axis=1)
            return nf * jnp.asarray(params.temperature, dtype) / v \
                - dudv

        return chunked_vmap(one_chain, chunk, state.com, state.quat,
                            state.active, state.box)

    return (init, run_steps, full_energy, widom_boltzmann,
            check_ewald_consistency, pressure_fd, widom_works)


class MolGibbsEnsemble:
    """Driver wrapper: blocks with the drift invariant and phase stats.

    >>> g = MolGibbsEnsemble(spce_system(48), params, dv_max=0.03)
    >>> st = g.init(key, boxes=(20.0, 24.0), n_init=(32, 8), n_chains=16)
    >>> st, stats = g.run_block(st, 5000, drift_tol=1e-9)
    """

    def __init__(self, system, params, dv_max=0.05, p_transfer=0.3,
                 dtype=jnp.float64, n_orient=1, chunk=8):
        self.params = params
        self.capacity = system.n_mol
        (self._init, self.run_steps, self.full_energy,
         self.widom_boltzmann, self._check_ewald,
         self.pressure_fd, self.widom_works) = make_gibbs_mol(
            system, params, dv_max,
                                            p_transfer, dtype,
                                            n_orient, chunk)

    def init(self, key, boxes, n_init, n_chains):
        return self._init(key, boxes, n_init, n_chains)

    def run_block(self, state, n_steps, drift_tol=None):
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        # volume exchange can grow a box past the Ewald-consistency
        # envelope checked at init — re-check at block boundaries
        self._check_ewald(np.asarray(jnp.max(state.box))[None])
        e, sf = self.full_energy(state)
        # both-endpoint drift scale (see mc/gcmc_mol.MolGCMC.run_block)
        scale = jnp.maximum(jnp.maximum(jnp.abs(e), jnp.abs(e_start)), 1.0)
        drift = jnp.max(jnp.abs(e - state.energy) / scale)
        sfac_err = jnp.max(jnp.abs(sf - state.sfac))
        n = jnp.sum(state.active, axis=2)                    # (C, 2)
        rho = n / state.box**3
        ratio = (state.acc - acc0) / jnp.maximum(state.att - att0, 1)
        rho_np = np.asarray(rho, np.float64)
        stats = {
            "n_mean": [float(x) for x in np.asarray(n).mean(axis=0)],
            "rho_liq": float(rho_np.max(axis=1).mean()),
            "rho_vap": float(rho_np.min(axis=1).mean()),
            "full_frac": float(jnp.mean((n >= self.capacity)
                                        .astype(jnp.float64))),
            "acc_disp": float(jnp.mean(ratio[:, 0])),
            "acc_rot": float(jnp.mean(ratio[:, 1])),
            "acc_vol": float(jnp.mean(ratio[:, 2])),
            "acc_transfer": float(jnp.mean(ratio[:, 3])),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None:
            assert stats["drift_max_rel"] < drift_tol, stats
        return state._replace(energy=e, sfac=sf), stats
