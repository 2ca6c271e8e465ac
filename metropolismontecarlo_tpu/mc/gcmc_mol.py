"""Grand-canonical (muVT) MC for rigid molecular species.

Extends the monatomic muVT app (`mc/gcmc.py`) to rigid polyatomics —
orientational insertions and full electrostatics — which neither the
reference (NVT-only, `Ewald/main.jl`) nor most teaching
codes attempt.  Moves: displacement, rotation, insertion at a uniform
position AND uniform orientation, deletion.  Acceptance (Frenkel & Smit
ch. 5; the uniform-orientation measure cancels, so the rotational
partition function is absorbed into the activity):

    insert:  min[1, z V / (N + 1) exp(-beta dU)]
    delete:  min[1, N / (z V)     exp(-beta dU)]

with z = exp(beta mu_total) including all internal/kinetic factors.

The data-parallel design mirrors gcmc.py: FIXED capacity of molecule slots
(static shapes), a per-chain activity mask, one attempt per `lax.scan`
step batched over chains by vmap, accept/reject by where-selects, and
slot selection by cumsum/argmax over the mask.  The energy model is
EXACTLY the sampled model of the main driver: all pose energies come
from `widom.make_pose_eval` (the Widom ghost machinery with an activity
mask and self-molecule exclusion), so GCMC insertion energies and Widom
insertion energies are one implementation.

Electrostatics: per-chain Ewald structure factors are carried state,
updated O(P K) per accepted move exactly as the NVT move path does
(reference `Ewald/ewalds.jl:718-826`); insertion adds the pose's
structure-factor row, deletion subtracts it, and the per-molecule
self + intramolecular constant enters only exchange moves (it cancels
in displacements/rotations).  Molecules must be charge-neutral under
"ewald" (a net-charged species would change the implicit background
with N).  Wolf (both conventions) and bare Coulomb are also supported;
the reference-Wolf global constant c*Q_tot^2 is tracked through N.

Exactness anchors (tests/test_gcmc_mol.py):
  * all-slots-active full energy == models/energy.energy_breakdown
    (exact, per coulomb style) — the pose-sum recompute and the
    production energy model agree to roundoff;
  * ideal rigid rotor (eps = q = 0): N ~ Poisson(z V), mean and
    variance (exercises the quaternion bookkeeping);
  * interacting LJ triatomic: beta mu_ex = ln(z / <rho>) vs the Widom
    machinery on an independent NVT run at the sampled density;
  * SPC/E water + Ewald: carried energy AND carried structure factors
    vs dense recompute after thousands of mixed moves (drift check).

Capacity truncation as in gcmc.py.  `use_lrc=True` (unshifted LJ only)
adds the species-level tail U_lrc = g(box) N^2 (`ops/tail.
mol_tail_coeff`) to the exchange constants and the dense recompute —
see mc/gcmc.py.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.mc.widom import make_pose_eval
from metropolismontecarlo_tpu.ops import ewald as ewald_ops
from metropolismontecarlo_tpu.ops.quaternions import (
    random_quaternion,
    random_rotate_quaternion,
)
from metropolismontecarlo_tpu.utils.activity import clear_slot, set_slot
from metropolismontecarlo_tpu.utils.chunking import chunked_vmap


class MolGCMCState(NamedTuple):
    com: jnp.ndarray      # (C, cap, 3) slot COMs (junk where inactive)
    quat: jnp.ndarray     # (C, cap, 4) slot orientations
    coords: jnp.ndarray   # (C, 3, A_pad) transposed atom planes, kept in
    #   sync with (com, quat) for ACTIVE slots only
    active: jnp.ndarray   # (C, cap) bool
    box: jnp.ndarray      # (C,)
    sfac: jnp.ndarray     # (C, K, 2) carried structure factors ((C,1,2) dummy)
    energy: jnp.ndarray   # (C,) carried total potential energy
    key: jnp.ndarray      # (C, 2) per-chain PRNG keys
    acc: jnp.ndarray      # (C, 4) accepted [trans, rot, insert, delete]
    att: jnp.ndarray      # (C, 4) attempted


def rosenbluth(neg_beta_u):
    """(count,) -beta*u (-inf for vetoed trials) -> (m, w) with
    sum_j exp(-beta u_j) = exp(m) * sum(w), stably."""
    m = jnp.max(neg_beta_u)
    m_safe = jnp.where(jnp.isfinite(m), m,
                       jnp.zeros((), neg_beta_u.dtype))
    w = jnp.exp(neg_beta_u - m_safe)              # exp(-inf) = 0 exactly
    return m_safe, w


def make_trial_quats(P, dtype):
    """Uniform-orientation trial sampler for a P-site rigid species
    (identity rows for point species)."""
    def trial_quats(k_q, count):
        if P > 1:
            return random_quaternion(k_q, (count,), dtype)
        return jnp.zeros((count, 4), dtype).at[:, 0].set(1.0)

    return trial_quats


def make_mol_slots(system, params, dtype=jnp.float64):
    """Shared rigid-molecule slot machinery for the muVT and Gibbs apps.

    Validates the system/params combination, then returns a namespace:
      ev — the `widom.make_pose_eval` pose evaluator;
      atom_ok_of(active (cap,)) -> (A_pad,) per-atom activity mask;
      write_pose(coords (3, A_pad), slot, ra (P, 3), keep) — conditional
          dynamic write of one molecule's atom columns;
      exchange_const(box, n_old, dn) — position-independent energy delta
          of changing N by dn (self + intra, reference-Wolf c*Q^2);
      full_one(com, quat, coords, active, box) -> (e, sfac (K, 2)) —
          dense masked recompute of one chain (the drift anchor);
      pose_lattice_init(key, box, n_chains) -> (com, quat, coords) —
          lattice slots with random orientations;
      plus fields P, cap, A, A_pad, K, kv, kw, use_ewald, q_t2.
    """
    from types import SimpleNamespace

    if not system.is_uniform:
        raise ValueError("molecular GCMC requires a uniform single-"
                         "species system (n_mol == slot capacity)")
    if params.ewald_surface:
        raise ValueError("ewald_surface is not supported in GCMC (the "
                         "whole-system dipole term would need deltas on "
                         "every move type)")
    if params.nlist_width != 0:
        raise ValueError("neighbor lists are not supported in GCMC")
    use_ewald = params.coulomb == "ewald"
    if use_ewald:
        kvecs, kweights = ewald_ops.make_kvectors(params.nk, params.ksq_max)
    else:
        kvecs = kweights = None

    ev = make_pose_eval(system, params, kvecs, kweights, dtype)
    if use_ewald and abs(ev.q_t_tot) > 1e-5:
        raise ValueError("ewald GCMC requires charge-neutral molecules "
                         f"(molecule net charge {ev.q_t_tot})")
    P = ev.P
    cap = system.n_mol
    A, A_pad = system.n_atoms, system.n_atoms_padded
    assert A == cap * P
    K = len(kvecs) if use_ewald else 1
    kv = None if kvecs is None else jnp.asarray(kvecs)
    kw = None if kweights is None else jnp.asarray(kweights, dtype)
    mol_of_atom = jnp.asarray(system.mol_of_atom_padded)   # (A_pad,), -1 pads
    real = mol_of_atom >= 0
    q_t2 = ev.q_t_tot**2

    def atom_ok_of(active):
        """(cap,) bool -> (A_pad,) bool: activity per atom column."""
        return real & active[jnp.clip(mol_of_atom, 0, cap - 1)]

    def write_pose(coords, slot, ra, keep):
        """Write pose atoms (P, 3) into molecule `slot`'s columns iff
        keep; coords (3, A_pad) transposed."""
        cur = jax.lax.dynamic_slice(coords, (0, slot * P), (3, P))
        new = jnp.where(keep, ra.T, cur)
        return jax.lax.dynamic_update_slice(coords, new, (0, slot * P))

    def exchange_const(box, n_old, dn):
        """Position-independent energy delta of changing N by dn:
        per-molecule self+intra, the reference-Wolf c*Q^2 term, and the
        LJ tail correction U_lrc = g(box) N^2 (both quadratic in N, so
        the delta is affine and kernel-friendly).  Box-dependent
        (kappa = kappa_L / box and g ~ 1/V), so transfers between
        different-sized boxes do NOT cancel it."""
        c = ev.self_intra(box) * dn
        nf = n_old.astype(dtype)
        dn2 = (nf + dn) ** 2 - nf**2
        if q_t2 != 0.0:
            c = c + ev.wolf_const_coeff(box) * q_t2 * dn2
        if ev.use_lrc:
            c = c + ev.lrc_self_coeff(box) * dn2
        return c

    def full_one(com, quat, coords, active, box):
        """Dense masked recompute of ONE chain: half the pose pair sums
        over active slots + reciprocal from active charges + N * const."""
        a_ok = atom_ok_of(active)

        def pose_e(m):
            ra = ev.pose_atoms(com[m], quat[m])
            e_m, _ = ev.pair_energy(com[m], ra, coords, com, box, a_ok, m)
            return jnp.where(active[m], e_m, 0.0)

        e = 0.5 * jnp.sum(jax.vmap(pose_e)(jnp.arange(cap)))
        nf = jnp.sum(active.astype(dtype))
        e = e + nf * ev.self_intra(box)
        if q_t2 != 0.0:
            e = e + ev.wolf_const_coeff(box) * q_t2 * nf * nf
        if ev.use_lrc:
            e = e + ev.lrc_self_coeff(box) * nf * nf
        if use_ewald:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
            q_eff = jnp.where(a_ok, ev.charges_flat, 0.0)
            sf = ewald_ops.structure_factor(coords.T, q_eff, kv, box)
            e = e + ewald_ops.recip_energy(sf, cf)
        else:
            sf = jnp.zeros((K, 2), dtype)
        return e, sf

    def pose_lattice_init(key, box, n_chains):
        """Lattice slot COMs + random orientations + synced coords
        (random placement seeds overlapped pairs that break the f64
        drift invariant — see mc/gcmc.py)."""
        from metropolismontecarlo_tpu.io.configs import cubic_lattice
        lat = jnp.asarray(cubic_lattice(cap, float(box)), dtype)
        com = jnp.broadcast_to(lat[None], (n_chains, cap, 3))
        if P > 1:
            quat = random_quaternion(key, (n_chains, cap), dtype)
        else:
            quat = jnp.zeros((n_chains, cap, 4), dtype).at[..., 0].set(1.0)
        ra = jax.vmap(jax.vmap(ev.pose_atoms))(com, quat)  # (C, cap, P, 3)
        coords = jnp.swapaxes(ra.reshape(n_chains, A, 3), 1, 2)
        coords = jnp.pad(coords, ((0, 0), (0, 0), (0, A_pad - A)))
        return com, quat, coords

    trial_quats = make_trial_quats(P, dtype)

    def pose_batch(com_t, quats, coords, com, box, a_ok, excl, sfac_base,
                   cf):
        """Energies of a batch of trial poses: (u_j, ovr_j, s_j) with
        u_j = pair + reciprocal delta vs sfac_base — the Rosenbluth
        trial evaluator (one batched (k, P, A_pad) pair grid + (k, K)
        structure factors).  com_t is (3,) for k orientations at one
        COM (orientational bias) or (k, 3) for k full poses
        (positional/cavity bias)."""
        coms = jnp.broadcast_to(com_t, (quats.shape[0], 3))

        def one(c, q):
            ra = ev.pose_atoms(c, q)
            e_p, ovr = ev.pair_energy(c, ra, coords, com, box, a_ok,
                                      excl)
            if use_ewald:
                s = ev.pose_sfac(ra, box)
                e_p = e_p + ewald_ops.recip_energy_delta(sfac_base, s, cf)
            else:
                s = jnp.zeros((K, 2), dtype)
            return e_p, ovr, s

        return jax.vmap(one)(coms, quats)

    return SimpleNamespace(
        ev=ev, P=P, cap=cap, A=A, A_pad=A_pad, K=K, kv=kv, kw=kw,
        use_ewald=use_ewald, q_t2=q_t2, atom_ok_of=atom_ok_of,
        write_pose=write_pose, exchange_const=exchange_const,
        full_one=full_one, pose_lattice_init=pose_lattice_init,
        trial_quats=trial_quats, pose_batch=pose_batch,
        rosenbluth=rosenbluth)


def make_gcmc_mol(system, params, activity, p_exchange=0.3,
                  dtype=jnp.float64, chunk=8, n_orient=1,
                  bias="orientation", tmmc=False):
    """Build the molecular-muVT step/energy functions.

    tmmc=True builds the TRANSITION-MATRIX variant (see mc/tmmc.py for
    the method): run_steps becomes run_steps(state, eta, n_steps) ->
    (state, cmat, uhist) where eta is the (cap+1,) bias applied to
    exchange acceptance only, cmat is the (C, cap+1, 3) per-call
    collection matrix of Rao-Blackwellized unbiased acceptance
    probabilities ([stay, up, down] columns, move-type probabilities
    folded in), and uhist the (C, cap+1, 3) per-slice canonical energy
    moments [count, sum E, sum E^2] for temperature extension.
    With eta = 0 the sampled trajectories are BIT-IDENTICAL to the
    tmmc=False build (gated in tests) — the bias enters acceptance
    thresholds only, never the proposal stream or the bookkeeping.

    system: a uniform single-species System whose n_mol IS the slot
    capacity (e.g. models/water.spce_system(64)).  activity: scalar,
    or a (n_chains,) ACTIVITY LADDER — each chain samples its own muVT
    state so one compiled run covers a whole adsorption isotherm /
    z-scan (see mc/gcmc.py; MBAR pooling applies unchanged).  Returns
    (init, run_steps, full_energy) with the same shapes as mc/gcmc.py;
    full_energy(state) -> (energy (C,), sfac (C, K, 2)).

    n_orient > 1 enables ORIENTATIONAL-BIAS exchanges (Rosenbluth
    k-trial sampling, Frenkel & Smit ch. 13.2): insertions draw k
    uniform orientations at the trial position, select one with
    probability exp(-beta u_j)/W, and accept with the W/k-corrected
    rule; deletions complete the reverse ensemble with k-1 fresh
    orientations at the molecule's COM.  Exact — n_orient only changes
    acceptance rates (large gains for strongly anisotropic molecules in
    dense phases), never the sampled distribution; n_orient = 1 is the
    unbiased algorithm.  The k trials are ONE batched
    (k, P, A_pad) pair-grid + (k, K) structure-factor evaluation.

    bias="pose" widens the trials from k orientations at ONE position
    to k FULL poses (independent uniform positions AND orientations);
    deletions complete the reverse ensemble with k-1 fresh full poses.
    The trial proposal density stays uniform per trial, so the W/k
    acceptance rule is unchanged and exactness is inherited (gated by
    the bias="pose" k=1-vs-k=8 ensemble-equality test).  Scope note
    (dense SPC/E): in the deep-rejection regime the
    acceptance RATE is c*E[W] regardless of trial correlation, so pose
    and orientation bias perform identically there; k-trial averaging
    of either kind only raises acceptance where single-trial Boltzmann
    factors saturate the Metropolis cap (Jensen on the concave min).
    """
    ms = make_mol_slots(system, params, dtype)
    ev, P, cap = ms.ev, ms.P, ms.cap
    A, A_pad, K = ms.A, ms.A_pad, ms.K
    kv, kw, use_ewald = ms.kv, ms.kw, ms.use_ewald
    atom_ok_of, write_pose = ms.atom_ok_of, ms.write_pose
    exchange_const = ms.exchange_const

    beta = jnp.asarray(1.0 / params.temperature, dtype)
    z_arr = jnp.asarray(activity, dtype)
    if z_arr.ndim not in (0, 1):
        raise ValueError("activity must be a scalar or a (n_chains,) "
                         "ladder")
    px = float(p_exchange)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    if bias not in ("orientation", "pose"):
        raise ValueError(f"bias must be 'orientation' or 'pose': {bias!r}")
    pose_bias = bias == "pose"
    # within non-exchange attempts, split params.p_translate : rest
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    neg_inf = jnp.asarray(-jnp.inf, dtype)
    trial_quats, pose_batch = ms.trial_quats, ms.pose_batch
    rosenbluth = ms.rosenbluth

    def _one_step(carry, _):
        if tmmc:
            (com, quat, coords, active, box, sfac, e, key, acc, att,
             cmat, uhist, eta, z) = carry
        else:
            (com, quat, coords, active, box, sfac, e, key, acc, att,
             z) = carry
        key, k = jax.random.split(key)
        (k_move, k_sel, k_pos, k_rot, k_insq, k_delq, k_pick,
         k_acc, k_inspos, k_delpos) = jax.random.split(k, 10)
        n = jnp.sum(active.astype(jnp.int32))
        nf = n.astype(dtype)
        u_move = jax.random.uniform(k_move, dtype=dtype)
        # move type: 0 displace, 1 rotate, 2 insert, 3 delete
        mt = jnp.where(u_move < p_disp, 0,
                       jnp.where(u_move < p_disp + p_rot, 1,
                                 jnp.where(u_move < p_disp + p_rot
                                           + 0.5 * px, 2, 3)))
        a_ok = atom_ok_of(active)

        # --- shared slot pick among the N active (displace/rotate/delete)
        u_sel = jax.random.uniform(k_sel, dtype=dtype)
        csum = jnp.cumsum(active.astype(jnp.int32))
        idx = jnp.argmax(csum >= jnp.floor(u_sel * nf).astype(jnp.int32) + 1)
        com_i, quat_i = com[idx], quat[idx]
        ra_old = ev.pose_atoms(com_i, quat_i)
        e_old, _ = ev.pair_energy(com_i, ra_old, coords, com, box, a_ok, idx)

        # --- displaced / rotated pose (statically skipped in exchange-
        # only builds: the second pair grid and second structure-factor
        # row are pure waste when mt can never select 0/1)
        move_on = p_disp + p_rot > 0.0
        if move_on:
            disp = (jax.random.uniform(k_pos, (3,), dtype) - 0.5) \
                * params.dr_max
            com_new = jnp.where(mt == 0, (com_i + disp) % box, com_i)
            quat_new = jnp.where(mt == 1,
                                 random_rotate_quaternion(k_rot, quat_i,
                                                          params.dphi_max),
                                 quat_i)
            ra_new = ev.pose_atoms(com_new, quat_new)
            e_new, ovr_new = ev.pair_energy(com_new, ra_new, coords, com,
                                            box, a_ok, idx)
        else:
            com_new, quat_new, ra_new = com_i, quat_i, ra_old
            e_new, ovr_new = e_old, jnp.asarray(False)

        # --- reciprocal prep for the move part -------------------------
        if use_ewald:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
            s_old = ev.pose_sfac(ra_old, box)
            s_new = ev.pose_sfac(ra_new, box) if move_on else s_old
            d_move = ewald_ops.recip_energy_delta(sfac, s_new - s_old, cf) \
                if move_on else jnp.zeros((), dtype)
        else:
            cf = None
            s_old = s_new = jnp.zeros((K, 2), dtype)
            d_move = jnp.zeros((), dtype)
        du_move = e_new - e_old + d_move

        # --- insertion: k trial orientations at one uniform position
        # (orientational bias), or k full uniform poses (cavity bias) ---
        # (Rosenbluth k-trials; n_or = 1 is the unbiased rule)
        if pose_bias:
            com_ins = jax.random.uniform(k_inspos, (n_or, 3), dtype) * box
        else:
            com_ins = jax.random.uniform(k_pos, (3,), dtype) * box
        quats_i = trial_quats(k_insq, n_or)
        u_i, ovr_i, s_i = pose_batch(com_ins, quats_i, coords, com, box,
                                     a_ok, -1, sfac, cf)
        slot = jnp.argmax(~active)
        full = n >= cap
        m_i, w_i = rosenbluth(jnp.where(ovr_i, neg_inf, -beta * u_i))
        w_sum_i = jnp.sum(w_i)
        u_pick = jax.random.uniform(k_pick, dtype=dtype)
        j_sel = jnp.argmax(jnp.cumsum(w_i) > u_pick * w_sum_i)
        quat_ins = quats_i[j_sel]
        com_ins = com_ins[j_sel] if pose_bias else com_ins
        ra_ins = ev.pose_atoms(com_ins, quat_ins)
        s_ins = s_i[j_sel]
        ec_ins = exchange_const(box, n, +1.0)
        du_ins = u_i[j_sel] + ec_ins

        # --- deletion: existing orientation + k-1 fresh trials ----------
        # trial energies are insertion energies into the system WITHOUT
        # molecule idx (pair: excl=idx; recip: vs sfac - s_old)
        sfac_wo = sfac - s_old if use_ewald else sfac
        if use_ewald:
            u_exist = e_old + ewald_ops.recip_energy_delta(sfac_wo, s_old,
                                                           cf)
        else:
            u_exist = e_old
        if n_or > 1:
            quats_d = trial_quats(k_delq, n_or - 1)
            if pose_bias:
                coms_d = jax.random.uniform(k_delpos, (n_or - 1, 3),
                                            dtype) * box
            else:
                coms_d = com_i
            u_d, ovr_d, _ = pose_batch(coms_d, quats_d, coords, com, box,
                                       a_ok, idx, sfac_wo, cf)
            neg_d = jnp.concatenate([(-beta * u_exist)[None],
                                     jnp.where(ovr_d, neg_inf,
                                               -beta * u_d)])
        else:
            neg_d = (-beta * u_exist)[None]
        m_d, w_d = rosenbluth(neg_d)
        w_sum_d = jnp.sum(w_d)
        ec_del = exchange_const(box, n, -1.0)
        du_del = -u_exist + ec_del

        # --- acceptance (log space; exact for n_or = 1) -----------------
        vol = box**3
        u = jax.random.uniform(k_acc, dtype=dtype)
        ln_u = jnp.log(jnp.maximum(u, jnp.asarray(1e-300, dtype)))
        ok_m = (mt <= 1) & (n > 0) & ~ovr_new \
            & (u < jnp.exp(-beta * du_move))
        ln_acc_i = jnp.log(z * vol / (nf + 1.0)) + m_i \
            + jnp.log(jnp.maximum(w_sum_i, 1e-300)) - float(np.log(n_or)) \
            - beta * ec_ins
        ln_acc_d = jnp.log(jnp.maximum(nf, 1.0) / (z * vol)) \
            + float(np.log(n_or)) - m_d \
            - jnp.log(jnp.maximum(w_sum_d, 1e-300)) - beta * ec_del
        if tmmc:
            # Rao-Blackwellized collection-matrix deposit of the
            # UNBIASED acceptance probabilities (min(1, e^ln_acc) =
            # e^min(ln_acc, 0); conditional on this step's trial set,
            # whose expectation is the macrostate transition
            # probability), with the exchange-type probability 0.5*px
            # folded in analytically — mirrors mc/tmmc.py
            pa_i = jnp.where(full | (w_sum_i <= 0.0), 0.0,
                             jnp.exp(jnp.minimum(ln_acc_i, 0.0)))
            pa_d = jnp.where(n > 0,
                             jnp.exp(jnp.minimum(ln_acc_d, 0.0)), 0.0)
            p_x = jnp.asarray(0.5 * px, dtype)
            up_v = p_x * pa_i
            dn_v = p_x * pa_d
            row = (jnp.arange(cap + 1) == n).astype(dtype)
            cmat = cmat + row[:, None] * jnp.stack(
                [1.0 - up_v - dn_v, up_v, dn_v])
            # per-slice canonical energy moments for temperature
            # extension (see tmmc.reweight_lnpi_temperature)
            uhist = uhist + row[:, None] * jnp.stack(
                [jnp.ones((), dtype), e, e * e])
            # bias enters the ACCEPTANCE THRESHOLD only (clamped index
            # reads are guarded by full / n==0 rejects)
            eta_n = eta[n]
            ln_acc_i = ln_acc_i + eta[jnp.minimum(n + 1, cap)] - eta_n
            ln_acc_d = ln_acc_d + eta[jnp.maximum(n - 1, 0)] - eta_n
        ok_i = (mt == 2) & ~full & (w_sum_i > 0.0) & (ln_u < ln_acc_i)
        ok_d = (mt == 3) & (n > 0) & (ln_u < ln_acc_d)

        # --- state updates (where-selects only)
        if move_on:
            com = com.at[idx].set(jnp.where(ok_m, com_new, com[idx]))
            quat = quat.at[idx].set(jnp.where(ok_m, quat_new, quat[idx]))
            coords = write_pose(coords, idx, ra_new, ok_m)
        com = com.at[slot].set(jnp.where(ok_i, com_ins, com[slot]))
        quat = quat.at[slot].set(jnp.where(ok_i, quat_ins, quat[slot]))
        coords = write_pose(coords, slot, ra_ins, ok_i)
        # one-hot where-selects, never bool scatters (utils/activity.py:
        # the bool-scatter hazard)
        active = set_slot(active, slot, ok_i)
        active = clear_slot(active, idx, ok_d)
        sfac = sfac \
            + jnp.where(ok_i, 1.0, 0.0) * s_ins \
            - jnp.where(ok_d, 1.0, 0.0) * s_old
        if move_on:
            sfac = sfac + jnp.where(ok_m, 1.0, 0.0) * (s_new - s_old)
        e = e + jnp.where(ok_i, du_ins, 0.0) \
            + jnp.where(ok_d, du_del, 0.0)
        if move_on:
            e = e + jnp.where(ok_m, du_move, 0.0)
        a_row = jnp.stack([ok_m & (mt == 0), ok_m & (mt == 1),
                           ok_i, ok_d]).astype(jnp.int32)
        t_row = (jnp.arange(4) == mt).astype(jnp.int32)
        if tmmc:
            carry = (com, quat, coords, active, box, sfac, e, key,
                     acc + a_row, att + t_row, cmat, uhist, eta, z)
        else:
            carry = (com, quat, coords, active, box, sfac, e, key,
                     acc + a_row, att + t_row, z)
        return carry, None

    def _run_chain(com, quat, coords, active, box, sfac, e, key, acc, att,
                   z, n_steps, eta=None):
        if tmmc:
            cmat = jnp.zeros((cap + 1, 3), dtype)
            uhist = jnp.zeros((cap + 1, 3), dtype)
            carry = (com, quat, coords, active, box, sfac, e, key, acc,
                     att, cmat, uhist, eta, z)
        else:
            carry = (com, quat, coords, active, box, sfac, e, key, acc,
                     att, z)
        carry, _ = jax.lax.scan(_one_step, carry, None, length=n_steps)
        return carry

    @jax.jit
    def full_energy(state):
        return chunked_vmap(ms.full_one, chunk, state.com, state.quat,
                            state.coords, state.active, state.box)

    def _z_of(state):
        """(C,) per-chain activity (ladder broadcast)."""
        return jnp.broadcast_to(z_arr, (state.com.shape[0],))

    if tmmc:
        @partial(jax.jit, static_argnums=2)
        def run_steps(state, eta, n_steps):
            out = jax.vmap(_run_chain,
                           in_axes=(0,) * 11 + (None, None))(
                state.com, state.quat, state.coords, state.active,
                state.box, state.sfac, state.energy, state.key,
                state.acc, state.att, _z_of(state), n_steps,
                jnp.asarray(eta, dtype))
            return MolGCMCState(*out[:10]), out[10], out[11]
    else:
        @partial(jax.jit, static_argnums=1)
        def run_steps(state, n_steps):
            out = jax.vmap(_run_chain, in_axes=(0,) * 11 + (None,))(
                state.com, state.quat, state.coords, state.active,
                state.box, state.sfac, state.energy, state.key,
                state.acc, state.att, _z_of(state), n_steps)
            return MolGCMCState(*out[:10])

    def init(key, box, n_init, n_chains):
        """n_init: scalar, or (n_chains,) per-chain STRATIFIED starts
        (see mc/tmmc.py — blanket the N axis so the collection matrix
        covers both basins from block 0)."""
        n0 = np.asarray(n_init, np.int32)
        if np.any(n0 > cap):
            raise ValueError("n_init exceeds capacity")
        if n0.ndim == 1 and n0.shape[0] != n_chains:
            raise ValueError("per-chain n_init must have n_chains entries")
        if z_arr.ndim == 1 and z_arr.shape[0] != n_chains:
            raise ValueError(
                f"activity ladder has {z_arr.shape[0]} rungs but "
                f"n_chains={n_chains} (one activity per chain)")
        if params.strict_min_image and box < 2.0 * max(params.r_cut,
                                                       params.qq_cut):
            raise ValueError(f"box {box} < 2*cutoff violates minimum-"
                             "image (set strict_min_image=False to "
                             "sample the truncated model)")
        k_chain, k_quat = jax.random.split(jnp.asarray(key))
        keys = jax.random.split(k_chain, n_chains)
        com, quat, coords = ms.pose_lattice_init(k_quat, box, n_chains)
        active = (jnp.arange(cap)[None, :]
                  < jnp.asarray(n0).reshape(-1, 1 if n0.ndim else 1))
        active = jnp.broadcast_to(active, (n_chains, cap))
        state = MolGCMCState(
            com=com, quat=quat, coords=coords, active=active,
            box=jnp.full((n_chains,), box, dtype),
            sfac=jnp.zeros((n_chains, K, 2), dtype),
            energy=jnp.zeros((n_chains,), dtype), key=keys,
            acc=jnp.zeros((n_chains, 4), jnp.int32),
            att=jnp.zeros((n_chains, 4), jnp.int32))
        e, sf = full_energy(state)
        return state._replace(energy=e, sfac=sf)

    return init, run_steps, full_energy


class MolGCMC:
    """Driver wrapper: blocks with the drift invariant and N statistics.

    >>> g = MolGCMC(spce_system(64), params, activity=3e-5)
    >>> st = g.init(key, box=20.0, n_init=24, n_chains=128)
    >>> st, stats = g.run_block(st, 2000, drift_tol=1e-9)
    """

    def __init__(self, system, params, activity, p_exchange=0.3,
                 dtype=jnp.float64, chunk=8, n_orient=1,
                 bias="orientation"):
        self.params = params
        self.capacity = system.n_mol
        self._system = system
        self._init, self.run_steps, self.full_energy = make_gcmc_mol(
            system, params, activity, p_exchange, dtype, chunk, n_orient,
            bias)

    def init(self, key, box, n_init, n_chains):
        return self._init(key, box, n_init, n_chains)

    def atom_mask(self, state):
        """(C, A_pad) per-atom activity mask (for the masked RDF/S(k)
        accumulators: observables.MaskedRDFAccumulator)."""
        moa = np.asarray(self._system.mol_of_atom_padded)
        real = jnp.asarray(moa >= 0)
        safe = jnp.asarray(np.clip(moa, 0, self.capacity - 1))
        return real[None, :] & state.active[:, safe]

    def run_block(self, state, n_steps, drift_tol=None):
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        e, sf = self.full_energy(state)
        # scale on BOTH block endpoints: a chain that traverses a large
        # energy range and ends near zero carries its f32/f64
        # cancellation residue relative to the traversal, not the
        # endpoint (same discipline as mc/tmmc.TMMCMol)
        scale = jnp.maximum(jnp.maximum(jnp.abs(e), jnp.abs(e_start)), 1.0)
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
