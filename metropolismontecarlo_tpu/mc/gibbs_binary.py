"""Gibbs-ensemble MC for BINARY mixtures: two-box coexistence with
per-species molecule transfers — binary vapor-liquid equilibrium
(composition splits, K-factors) without chemical potentials.

The two-component Gibbs ensemble (Panagiotopoulos 1987; Frenkel &
Smit ch. 8.3): total N of EACH species and total volume are fixed,
the two boxes exchange volume and molecules of either species, and at
equilibrium every species' chemical potential (and the pressure)
equalizes between the boxes — the mixture coexistence point with the
compositions emerging from the sampling.  Composes the proven parts:
the two-species slot machinery of `mc/gcmc_binary.make_binary_slots`
and the two-box structure of `mc/gibbs_mol.py` (per-box carried Ewald
structure factors, deterministic volume-transfer cycle, Rosenbluth
orientational-bias transfers per species).

Moves:
    displace / rotate: random box, random active molecule of EITHER
        species (where-selected species energies);
    volume (deterministic cycle, see mc/gibbs.py): dV transfer between
        the boxes, COMs rescaled with orientations fixed, both boxes
        fully recomputed;  acceptance uses the TOTAL molecule count of
        each box, min[1, (V1'/V1)^(N1_tot) (V2'/V2)^(N2_tot) e^-b dU];
    transfer of species s: remove a uniform active s-molecule from box
        b, insert at a uniform pose into box 1-b,
        min[1, N_s,src V_dst / ((N_s,dst + 1) V_src) exp(-beta dU)]
        with dU including both boxes' pair + reciprocal deltas and the
        box-dependent self+intra constants (they do NOT cancel between
        different-sized boxes — see mc/gibbs_mol.py).

Exactness anchors (tests/test_gibbs_binary.py):
  * ideal two species (eps = q = 0, fixed volumes): each species
    partitions independently, N_s,box1 ~ Binomial(N_s, V1/(V1+V2));
  * COLOR symmetry: two identical interacting species reproduce the
    single-species molecular Gibbs ensemble's total-N partitioning
    (labels are colors — same argument as the muVT gate);
  * Ewald drift + structure-factor drift through mixed transfers and
    volume exchanges (the framework-wide invariant).

The same box-dependent-truncation guard as gibbs_mol applies: both
boxes must sample the SAME converged Ewald model
(`check_ewald_consistency`, measured failure mode in CLAUDE.md).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.mc.gcmc_binary import make_binary_slots
from metropolismontecarlo_tpu.utils.activity import clear_slot2, set_slot2
from metropolismontecarlo_tpu.ops import ewald as ewald_ops
from metropolismontecarlo_tpu.ops.quaternions import random_rotate_quaternion
from metropolismontecarlo_tpu.utils.chunking import chunked_vmap


class BinaryGibbsState(NamedTuple):
    com: jnp.ndarray      # (C, 2, M, 3)
    quat: jnp.ndarray     # (C, 2, M, 4)
    coords: jnp.ndarray   # (C, 2, 3, A_pad)
    active0: jnp.ndarray  # (C, 2, cap0) bool
    active1: jnp.ndarray  # (C, 2, cap1) bool
    box: jnp.ndarray      # (C, 2)
    sfac: jnp.ndarray     # (C, 2, K, 2)
    energy: jnp.ndarray   # (C, 2)
    key: jnp.ndarray      # (C, 2)
    acc: jnp.ndarray      # (C, 5) [disp, rot, vol, transfer0, transfer1]
    att: jnp.ndarray      # (C, 5)


def make_gibbs_binary(system, params, dv_max=0.05, p_transfer=0.3,
                      dtype=jnp.float64, n_orient=1, chunk=8,
                      npt_pressure=None):
    """Build the binary Gibbs-ensemble step/energy functions.

    system: a two-species-block System; each block's molecule count is
    that species' PER-BOX slot capacity.  Returns (init, run_steps,
    full_energy, check_ewald_consistency).  Transfer attempts split
    p_transfer equally between the species.

    npt_pressure (K/A^3): CONSTANT-PRESSURE Gibbs ensemble
    (Panagiotopoulos's NPT-Gibbs variant, valid for MIXTURES only —
    the phase rule over-determines a pure substance at fixed T and P):
    instead of the coupled dV transfer between the boxes, each volume
    attempt picks one box uniformly and samples it against the
    pressure bath, min[1, exp(N_b ln(V_b'/V_b) - beta dU - beta P dV)]
    — both boxes reach mechanical equilibrium with the bath, and
    per-species transfers still equalize the chemical potentials, so
    the system finds the coexistence COMPOSITIONS at the given (T, P).
    dv_max is then the ln-V half-width of the chosen box's move
    (matching the NPT driver's dlnv convention), not a fraction of the
    total volume.
    Exactness anchor: at eps = q = 0 with transfers off each box is an
    ideal-gas NPT cell, V_b ~ Gamma(N_b + 1, kT/P) in closed form.
    """
    ms = make_binary_slots(system, params, dtype)
    evs, caps, m0s, a0s, Ps = ms.evs, ms.caps, ms.m0s, ms.a0s, ms.Ps
    K, use_ewald = ms.K, ms.use_ewald

    beta = jnp.asarray(1.0 / params.temperature, dtype)
    p_v = float(params.p_volume)
    px = float(p_transfer)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    neg_inf = jnp.asarray(-jnp.inf, dtype)
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    wall = 2.0 * max(params.r_cut, params.qq_cut) \
        if params.strict_min_image else 0.0

    def check_ewald_consistency(boxes, tol=5e-3):
        """Both boxes must sample the SAME truncated Ewald model — see
        mc/gibbs_mol.py for the measured failure mode (molecules drain
        into the box whose mangled electrostatics are softer)."""
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
                "tune kappa_L/nk/ksq_max with ops.ewald."
                "tune_parameters(max_box, r_cut, tol)")

    def cf_of(box):
        if not use_ewald:
            return None
        kappa = jnp.asarray(params.kappa_L, dtype) / box
        return ewald_ops.cfac_coeffs(ms.kv, ms.kw, kappa, box, dtype)

    def recip_delta(sfac_b, ds, cf):
        if not use_ewald:
            return jnp.zeros((), dtype)
        return ewald_ops.recip_energy_delta(sfac_b, ds, cf)

    def _cheap_step(carry, _):
        (com, quat, coords, active0, active1, box, sfac, e, key,
         acc, att) = carry
        key, k = jax.random.split(key)
        (k_move, k_box, k_xpos, k_sel, k_pos, k_rot, k_insq, k_delq,
         k_dsel, k_pick, k_acc) = jax.random.split(k, 11)
        actives = (active0, active1)
        n = tuple(jnp.sum(a.astype(jnp.int32), axis=1)        # (2,)
                  for a in actives)
        v = box**3
        u_move = jax.random.uniform(k_move, dtype=dtype)
        # 0 disp, 1 rot, 3 transfer-sp0, 4 transfer-sp1 (2 = volume)
        mt = jnp.where(u_move < p_disp, 0,
                       jnp.where(u_move < p_disp + p_rot, 1,
                                 jnp.where(u_move < p_disp + p_rot
                                           + 0.5 * px, 3, 4)))
        u = jax.random.uniform(k_acc, dtype=dtype)
        ln_u = jnp.log(jnp.maximum(u, jnp.asarray(1e-300, dtype)))
        b = jax.random.bernoulli(k_box).astype(jnp.int32)
        d = 1 - b
        cf_b, cf_d = cf_of(box[b]), cf_of(box[d])
        a_ok_b = ms.atom_ok_of(active0[b], active1[b])
        a_ok_d = ms.atom_ok_of(active0[d], active1[d])

        # --- displacement/rotation: pick among ALL active of box b ----
        all_b = jnp.concatenate([active0[b], active1[b]])
        n_tot_b = n[0][b] + n[1][b]
        u_sel = jax.random.uniform(k_sel, dtype=dtype)
        csum = jnp.cumsum(all_b.astype(jnp.int32))
        idx = jnp.argmax(csum >= jnp.floor(
            u_sel * n_tot_b.astype(dtype)).astype(jnp.int32) + 1)
        is_a = idx < caps[0]
        com_i, quat_i = com[b, idx], quat[b, idx]
        # statically skipped in transfer-only builds
        move_on = p_disp + p_rot > 0.0
        disp = (jax.random.uniform(k_pos, (3,), dtype) - 0.5) \
            * params.dr_max
        com_new = jnp.where(mt == 0, (com_i + disp) % box[b], com_i)
        quat_new = jnp.where(mt == 1,
                             random_rotate_quaternion(k_rot, quat_i,
                                                      params.dphi_max),
                             quat_i)

        def species_pair(ev_s):
            ra_o = ev_s.pose_atoms(com_i, quat_i)
            e_o, _ = ev_s.pair_energy(com_i, ra_o, coords[b], com[b],
                                      box[b], a_ok_b, idx)
            ra_n = ev_s.pose_atoms(com_new, quat_new)
            e_n, ovr_n = ev_s.pair_energy(com_new, ra_n, coords[b],
                                          com[b], box[b], a_ok_b, idx)
            if use_ewald:
                s_o = ev_s.pose_sfac(ra_o, box[b])
                s_n = ev_s.pose_sfac(ra_n, box[b])
            else:
                s_o = s_n = jnp.zeros((K, 2), dtype)
            return ra_n, e_o, e_n, ovr_n, s_o, s_n

        if move_on:
            raA_n, eA_o, eA_n, ovrA, sA_o, sA_n = species_pair(evs[0])
            raB_n, eB_o, eB_n, ovrB, sB_o, sB_n = species_pair(evs[1])
            e_new = jnp.where(is_a, eA_n, eB_n)
            e_old = jnp.where(is_a, eA_o, eB_o)
            ovr_new = jnp.where(is_a, ovrA, ovrB)
            s_old = jnp.where(is_a, sA_o, sB_o)
            s_new = jnp.where(is_a, sA_n, sB_n)
            du_move = e_new - e_old + recip_delta(sfac[b],
                                                  s_new - s_old, cf_b)
            ok_m = (mt <= 1) & (n_tot_b > 0) & ~ovr_new \
                & (u < jnp.exp(-beta * du_move))
        else:
            ok_m = jnp.asarray(False)

        # --- per-species transfer b -> d machinery --------------------
        k_ip = jax.random.split(k_xpos, 2)
        k_iq = jax.random.split(k_insq, 2)
        k_dq = jax.random.split(k_delq, 2)
        k_ds = jax.random.split(k_dsel, 2)
        k_pk = jax.random.split(k_pick, 2)
        xfer = []
        for s in (0, 1):
            nf_src = n[s][b].astype(dtype)
            nf_dst = n[s][d].astype(dtype)
            # destination insertion: n_or trial orientations at one
            # uniform position in box d
            pos_d = jax.random.uniform(k_ip[s], (3,), dtype) * box[d]
            quats_i = ms.trial_quats[s](k_iq[s], n_or)
            u_i, ovr_i, s_i = ms.pose_batch(s, pos_d, quats_i,
                                            coords[d], com[d], box[d],
                                            a_ok_d, -1, sfac[d], cf_d)
            m_i, w_i = ms.rosenbluth(jnp.where(ovr_i, neg_inf,
                                               -beta * u_i))
            w_sum_i = jnp.sum(w_i)
            u_pick = jax.random.uniform(k_pk[s], dtype=dtype)
            j_sel = jnp.argmax(jnp.cumsum(w_i) > u_pick * w_sum_i)
            quat_ins = quats_i[j_sel]
            ra_ins = evs[s].pose_atoms(pos_d, quat_ins)
            slot_d = jnp.argmax(~actives[s][d])
            # source removal: uniform active s-molecule of box b
            u_sd = jax.random.uniform(k_ds[s], dtype=dtype)
            csum_s = jnp.cumsum(actives[s][b].astype(jnp.int32))
            slot_s = jnp.argmax(csum_s >= jnp.floor(u_sd * nf_src)
                                .astype(jnp.int32) + 1)
            mol_s = m0s[s] + slot_s
            com_s, quat_s = com[b, mol_s], quat[b, mol_s]
            ra_s = evs[s].pose_atoms(com_s, quat_s)
            e_s, _ = evs[s].pair_energy(com_s, ra_s, coords[b], com[b],
                                        box[b], a_ok_b, mol_s)
            if use_ewald:
                s_s = evs[s].pose_sfac(ra_s, box[b])
                sfac_wo = sfac[b] - s_s
                u_exist = e_s + ewald_ops.recip_energy_delta(
                    sfac_wo, s_s, cf_b)
            else:
                s_s = jnp.zeros((K, 2), dtype)
                sfac_wo = sfac[b]
                u_exist = e_s
            if n_or > 1:
                quats_o = ms.trial_quats[s](k_dq[s], n_or - 1)
                u_o, ovr_o, _ = ms.pose_batch(s, com_s, quats_o,
                                              coords[b], com[b],
                                              box[b], a_ok_b, mol_s,
                                              sfac_wo, cf_b)
                neg_o = jnp.concatenate([(-beta * u_exist)[None],
                                         jnp.where(ovr_o, neg_inf,
                                                   -beta * u_o)])
            else:
                neg_o = (-beta * u_exist)[None]
            m_o, w_o = ms.rosenbluth(neg_o)
            w_sum_o = jnp.sum(w_o)
            ec_d = ms.exchange_const(box[d], n[0][d], n[1][d], s, +1.0)
            ec_s = ms.exchange_const(box[b], n[0][b], n[1][b], s, -1.0)
            ln_acc = jnp.log(jnp.maximum(nf_src, 1.0) * v[d]
                             / ((nf_dst + 1.0) * v[b])) \
                + m_i + jnp.log(jnp.maximum(w_sum_i, 1e-300)) \
                - m_o - jnp.log(jnp.maximum(w_sum_o, 1e-300)) \
                - beta * (ec_d + ec_s)
            ok = (mt == 3 + s) & (n[s][b] > 0) & (n[s][d] < caps[s]) \
                & (w_sum_i > 0.0) & (ln_u < ln_acc)
            xfer.append(dict(
                ok=ok, pos=pos_d, quat=quat_ins, ra_in=ra_ins,
                s_in=s_i[j_sel], slot_d=slot_d, slot_s=slot_s,
                ra_s=ra_s, s_s=s_s,
                du_d=u_i[j_sel] + ec_d, du_s=-u_exist + ec_s))

        # --- apply ----------------------------------------------------
        if move_on:
            com = com.at[b, idx].set(jnp.where(ok_m, com_new,
                                               com[b, idx]))
            quat = quat.at[b, idx].set(jnp.where(ok_m, quat_new,
                                                 quat[b, idx]))
            a0_mA = jnp.where(is_a, a0s[0] + (idx - m0s[0]) * Ps[0], 0)
            coords = coords.at[b].set(ms.write_pose(
                coords[b], a0_mA, Ps[0], raA_n, ok_m & is_a))
            a0_mB = jnp.where(is_a, 0, a0s[1] + (idx - m0s[1]) * Ps[1])
            coords = coords.at[b].set(ms.write_pose(
                coords[b], a0_mB, Ps[1], raB_n, ok_m & ~is_a))
            sfac = sfac.at[b].add(jnp.where(ok_m, 1.0, 0.0)
                                  * (s_new - s_old))
            e = e.at[b].add(jnp.where(ok_m, du_move, 0.0))
        new_actives = [active0, active1]
        for s in (0, 1):
            x = xfer[s]
            w_x = jnp.where(x["ok"], 1.0, 0.0)
            mol_d = m0s[s] + x["slot_d"]
            com = com.at[d, mol_d].set(jnp.where(x["ok"], x["pos"],
                                                 com[d, mol_d]))
            quat = quat.at[d, mol_d].set(jnp.where(x["ok"], x["quat"],
                                                   quat[d, mol_d]))
            coords = coords.at[d].set(ms.write_pose(
                coords[d], a0s[s] + x["slot_d"] * Ps[s], Ps[s],
                x["ra_in"], x["ok"]))
            # one-hot where-selects, never bool scatters
            # (utils/activity.py: the bool-scatter hazard)
            act = set_slot2(new_actives[s], d, x["slot_d"], x["ok"])
            act = clear_slot2(act, b, x["slot_s"], x["ok"])
            new_actives[s] = act
            sfac = sfac.at[d].add(w_x * x["s_in"])
            sfac = sfac.at[b].add(-w_x * x["s_s"])
            e = e.at[d].add(jnp.where(x["ok"], x["du_d"], 0.0))
            e = e.at[b].add(jnp.where(x["ok"], x["du_s"], 0.0))
        a_row = jnp.stack([ok_m & (mt == 0), ok_m & (mt == 1),
                           jnp.zeros((), bool), xfer[0]["ok"],
                           xfer[1]["ok"]]).astype(jnp.int32)
        # mt in {0, 1, 3, 4}; row 2 (volume) rides the cycle schedule
        t_row = (jnp.arange(5) == mt).astype(jnp.int32)
        carry = (com, quat, coords, new_actives[0], new_actives[1],
                 box, sfac, e, key, acc + a_row, att + t_row)
        return carry, None

    def rebuild(c_one, q_one):
        """Atoms (3, A_pad) for one box from (M, 3)/(M, 4) slot poses,
        each species block reshaped at its own width."""
        ra0 = jax.vmap(evs[0].pose_atoms)(
            c_one[m0s[0]:m0s[0] + caps[0]],
            q_one[m0s[0]:m0s[0] + caps[0]])
        ra1 = jax.vmap(evs[1].pose_atoms)(
            c_one[m0s[1]:m0s[1] + caps[1]],
            q_one[m0s[1]:m0s[1] + caps[1]])
        flat = jnp.concatenate(
            [ra0.reshape(caps[0] * Ps[0], 3),
             ra1.reshape(caps[1] * Ps[1], 3)], 0)
        out = jnp.swapaxes(flat, 0, 1)
        pad = ms.A_pad - ms.A
        if pad:
            out = jnp.pad(out, ((0, 0), (0, pad)))
        return out

    def _vol_step(carry):
        (com, quat, coords, active0, active1, box, sfac, e, key,
         acc, att) = carry
        key, k = jax.random.split(key)
        k_pos, k_box, k_acc = jax.random.split(k, 3)
        n_tot = (jnp.sum(active0.astype(jnp.int32), axis=1)
                 + jnp.sum(active1.astype(jnp.int32), axis=1))  # (2,)
        nf = n_tot.astype(dtype)
        v = box**3
        if npt_pressure is None:
            # NVT-Gibbs: dV transfers between the boxes (total V fixed)
            dv = (jax.random.uniform(k_pos, dtype=dtype) - 0.5) * 2.0 \
                * dv_max * jnp.sum(v)
            v_new = v + jnp.stack([dv, -dv])
            bath = jnp.zeros((), dtype)
        else:
            # NPT-Gibbs: one box per attempt against the pressure bath,
            # proposed in ln V exactly like the NPT driver (mc/npt.py:
            # dlnv uniform in +-dv_max; the ln-V measure contributes
            # the +1 in the (N_b + 1) ln(V'/V) acceptance exponent,
            # folded into `bath` below with a negative sign)
            b = jax.random.bernoulli(k_box).astype(jnp.int32)
            dlnv = (2.0 * jax.random.uniform(k_pos, dtype=dtype) - 1.0) \
                * dv_max
            v_b_new = v[b] * jnp.exp(dlnv)
            v_new = v.at[b].set(v_b_new)
            bath = beta * jnp.asarray(npt_pressure, dtype) \
                * (v_b_new - v[b]) - dlnv
        box_new = jnp.cbrt(v_new)
        legal = jnp.all(box_new > wall) & jnp.all(v_new > 0.0)
        box_t = jnp.where(legal, box_new, box)
        scale = jnp.where(legal, box_new / box, 1.0)
        com_v = com * scale[:, None, None]
        coords_v = jax.vmap(rebuild)(com_v, quat)
        e_v, sf_v = jax.vmap(ms.full_one)(com_v, quat, coords_v,
                                          active0, active1, box_t)
        log_a = jnp.sum(nf * jnp.log(jnp.where(legal, v_new / v, 1.0))) \
            - beta * jnp.sum(e_v - e) - jnp.where(legal, bath, 0.0)
        u = jax.random.uniform(k_acc, dtype=dtype)
        ok_v = legal & (jnp.log(jnp.maximum(u, 1e-300)) < log_a)
        com = jnp.where(ok_v, com_v, com)
        coords = jnp.where(ok_v, coords_v, coords)
        box = jnp.where(ok_v, box_new, box)
        sfac = sfac + jnp.where(ok_v, 1.0, 0.0) * (sf_v - sfac)
        e = jnp.where(ok_v, e_v, e)
        acc = acc.at[2].add(ok_v.astype(jnp.int32))
        att = att.at[2].add(1)
        return (com, quat, coords, active0, active1, box, sfac, e,
                key, acc, att)

    period = int(round(1.0 / p_v)) if p_v > 0 else 0

    def _run_chain(com, quat, coords, active0, active1, box, sfac, e,
                   key, acc, att, n_steps):
        carry = (com, quat, coords, active0, active1, box, sfac, e,
                 key, acc, att)
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
        def both(com, quat, coords, active0, active1, box):
            return jax.vmap(ms.full_one)(com, quat, coords, active0,
                                         active1, box)

        return chunked_vmap(both, chunk, state.com, state.quat,
                            state.coords, state.active0, state.active1,
                            state.box)

    @partial(jax.jit, static_argnums=1)
    def run_steps(state, n_steps):
        out = jax.vmap(_run_chain, in_axes=(0,) * 11 + (None,))(
            state.com, state.quat, state.coords, state.active0,
            state.active1, state.box, state.sfac, state.energy,
            state.key, state.acc, state.att, n_steps)
        return BinaryGibbsState(*out)

    def init(key, boxes, n_init, n_chains):
        """boxes (2,) edges; n_init (2, 2) = [species][box] counts."""
        n_init = np.asarray(n_init, np.int64)
        if n_init.shape != (2, 2):
            raise ValueError("n_init must be (2 species, 2 boxes)")
        for s in (0, 1):
            if np.any(n_init[s] > caps[s]):
                raise ValueError(f"species-{s} n_init {n_init[s]} "
                                 f"exceeds capacity {caps[s]}")
        if params.strict_min_image and min(boxes) < wall:
            raise ValueError(
                f"box {min(boxes)} < 2*cutoff ({wall}) violates "
                "minimum-image (set strict_min_image=False to sample "
                "the truncated model)")
        check_ewald_consistency(np.asarray(boxes))
        k_chain, k1, k2 = jax.random.split(jnp.asarray(key), 3)
        keys = jax.random.split(k_chain, n_chains)
        per_box = [ms.pose_lattice_init(kk, float(bx), n_chains)
                   for kk, bx in zip((k1, k2), np.asarray(boxes))]
        com = jnp.stack([p[0] for p in per_box], axis=1)
        quat = jnp.stack([p[1] for p in per_box], axis=1)
        coords = jnp.stack([p[2] for p in per_box], axis=1)
        act = []
        for s in (0, 1):
            a = jnp.arange(caps[s])[None, :] \
                < jnp.asarray(n_init[s])[:, None]          # (2, cap_s)
            act.append(jnp.broadcast_to(a, (n_chains, 2, caps[s])))
        state = BinaryGibbsState(
            com=com, quat=quat, coords=coords,
            active0=act[0], active1=act[1],
            box=jnp.broadcast_to(jnp.asarray(boxes, dtype),
                                 (n_chains, 2)),
            sfac=jnp.zeros((n_chains, 2, K, 2), dtype),
            energy=jnp.zeros((n_chains, 2), dtype), key=keys,
            acc=jnp.zeros((n_chains, 5), jnp.int32),
            att=jnp.zeros((n_chains, 5), jnp.int32))
        e, sf = full_energy(state)
        return state._replace(energy=e, sfac=sf)

    @jax.jit
    def pressure_fd(state, rel=1e-4):
        """(C, 2) exact pressure of the sampled model per box, K/A^3:
        P = N_tot k T / V - dU/dV by central finite difference on the
        COM-rescaled (rigid-molecule) energy — the same dU/dV route as
        the NPT driver's pressure_fd (mc/driver.py), applied per box.
        At Gibbs coexistence the two boxes' pressures must agree (the
        ensemble's fixed point), and the vapor box's value IS the
        saturation pressure of the sampled model."""
        def one_box(com_b, quat_b, a0_b, a1_b, box_b):
            v = box_b**3

            def e_at(s):
                com_s = com_b * s
                coords_s = rebuild(com_s, quat_b)
                e, _ = ms.full_one(com_s, quat_b, coords_s, a0_b, a1_b,
                                   box_b * s)
                return e

            s_hi = jnp.asarray((1.0 + rel) ** (1.0 / 3.0), dtype)
            s_lo = jnp.asarray((1.0 - rel) ** (1.0 / 3.0), dtype)
            dudv = (e_at(s_hi) - e_at(s_lo)) / (2.0 * rel * v)
            n_tot = (jnp.sum(a0_b.astype(dtype))
                     + jnp.sum(a1_b.astype(dtype)))
            return n_tot * jnp.asarray(params.temperature, dtype) / v \
                - dudv

        def both(com, quat, active0, active1, box):
            return jax.vmap(one_box)(com, quat, active0, active1, box)

        return chunked_vmap(both, chunk, state.com, state.quat,
                            state.active0, state.active1, state.box)

    @partial(jax.jit, static_argnums=(2, 3))
    def widom_boltzmann(state, key, n_insertions, species):
        """(C, 2) mean exp(-beta dU_test) per box for ghost insertions
        of the given species, dU with the full exchange energetics —
        beta mu_s = ln rho_s - ln(this) in the same convention for both
        boxes, so PER-SPECIES equality is the mixture-coexistence
        diagnostic (see mc/gibbs_mol.widom_boltzmann)."""
        s = int(species)

        def one(com, quat, coords, active0, active1, box, sfac, k):
            kp, kq = jax.random.split(k)
            pos = jax.random.uniform(kp, (n_insertions, 3),
                                     dtype) * box
            quats = ms.trial_quats[s](kq, n_insertions)
            n0 = jnp.sum(active0.astype(jnp.int32))
            n1 = jnp.sum(active1.astype(jnp.int32))
            a_ok = ms.atom_ok_of(active0, active1)
            cf = cf_of(box)
            ec = ms.exchange_const(box, n0, n1, s, +1.0)

            def du_one(p, q):
                ra = evs[s].pose_atoms(p, q)
                e_p, ovr = evs[s].pair_energy(p, ra, coords, com, box,
                                              a_ok, -1)
                if use_ewald:
                    e_p = e_p + ewald_ops.recip_energy_delta(
                        sfac, evs[s].pose_sfac(ra, box), cf)
                return jnp.where(ovr, 0.0, jnp.exp(-beta * (e_p + ec)))

            return jnp.mean(jax.vmap(du_one)(pos, quats))

        C = state.com.shape[0]
        ks = jax.random.split(jnp.asarray(key), C * 2).reshape(C, 2, 2)
        return jax.vmap(jax.vmap(one))(state.com, state.quat,
                                       state.coords, state.active0,
                                       state.active1, state.box,
                                       state.sfac, ks)

    return (init, run_steps, full_energy, check_ewald_consistency,
            pressure_fd, widom_boltzmann)


class BinaryGibbsEnsemble:
    """Driver wrapper: blocks with the drift invariant and per-phase
    composition statistics.

    >>> g = BinaryGibbsEnsemble(co2_n2_system(64, 64), params)
    >>> st = g.init(key, boxes=(22.0, 30.0), n_init=[[40, 8], [10, 20]],
    ...             n_chains=32)
    >>> st, stats = g.run_block(st, 4000, drift_tol=1e-9)
    """

    def __init__(self, system, params, dv_max=0.05, p_transfer=0.3,
                 dtype=jnp.float64, n_orient=1, chunk=8,
                 npt_pressure=None):
        self.params = params
        (self._init, self.run_steps, self.full_energy,
         self._check_ewald, self.pressure_fd,
         self.widom_boltzmann) = make_gibbs_binary(
            system, params, dv_max, p_transfer, dtype, n_orient, chunk, npt_pressure=npt_pressure)
        sl = system.species_slices
        self.capacities = (sl[0][2] - sl[0][1], sl[1][2] - sl[1][1])

    def init(self, key, boxes, n_init, n_chains):
        return self._init(key, boxes, n_init, n_chains)

    def run_block(self, state, n_steps, drift_tol=None):
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        self._check_ewald(np.asarray(jnp.max(state.box))[None])
        e, sf = self.full_energy(state)
        # both-endpoint drift scale (see mc/gcmc_mol.MolGCMC.run_block)
        scale = jnp.maximum(jnp.maximum(jnp.abs(e), jnp.abs(e_start)), 1.0)
        drift = jnp.max(jnp.abs(e - state.energy) / scale)
        sfac_err = jnp.max(jnp.abs(sf - state.sfac))
        n0 = jnp.sum(state.active0, axis=2)          # (C, 2)
        n1 = jnp.sum(state.active1, axis=2)
        v = state.box**3
        rho = (n0 + n1) / v
        # per-chain phase labels by total density: liq = denser box
        liq = jnp.argmax(rho, axis=1)                # (C,)
        ch = jnp.arange(rho.shape[0])
        x0 = n0.astype(jnp.float64) \
            / jnp.maximum((n0 + n1).astype(jnp.float64), 1.0)
        ratio = (state.acc - acc0) / jnp.maximum(state.att - att0, 1)
        stats = {
            "n0_mean": [float(x) for x in
                        np.asarray(n0, np.float64).mean(axis=0)],
            "n1_mean": [float(x) for x in
                        np.asarray(n1, np.float64).mean(axis=0)],
            "rho_liq": float(jnp.mean(rho[ch, liq])),
            "rho_vap": float(jnp.mean(rho[ch, 1 - liq])),
            "x0_liq": float(jnp.mean(x0[ch, liq])),
            "x0_vap": float(jnp.mean(x0[ch, 1 - liq])),
            "acc_disp": float(jnp.mean(ratio[:, 0])),
            "acc_rot": float(jnp.mean(ratio[:, 1])),
            "acc_vol": float(jnp.mean(ratio[:, 2])),
            "acc_transfer0": float(jnp.mean(ratio[:, 3])),
            "acc_transfer1": float(jnp.mean(ratio[:, 4])),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None:
            assert stats["drift_max_rel"] < drift_tol, stats
            assert not np.isnan(stats["rho_liq"]), stats
        return state._replace(energy=e, sfac=sf), stats
