"""Gibbs-ensemble Monte Carlo: two-box vapor-liquid coexistence.

Beyond-parity ensemble app (Panagiotopoulos 1987; Frenkel & Smit ch. 8):
each chain carries TWO boxes exchanging particles and volume at fixed
total N and V, so the two boxes equilibrate to coexisting phases with
equal T, P, and mu — phase equilibria without ever computing a free
energy.  Moves and acceptance rules:

    displace (prob p_translate):  standard Metropolis in a random box;
    volume   (every round(1/p_volume) steps, deterministic cycle as in
        mc/npt.py):               dV transfer, both boxes rescaled,
        min[1, (V1'/V1)^N1 (V2'/V2)^N2 exp(-beta dU_total)];
    transfer (rest):              remove a random particle from box s,
        insert at a uniform position of box d,
        min[1, N_s V_d / ((N_d + 1) V_s) exp(-beta dU)].

Data-parallel design, shared with the muVT app (`mc/gcmc.py:make_slot_lj`):
fixed capacity slots per box with activity masks (static shapes), the
step loop one `lax.scan` vmapped over chains, where-select acceptance.
Volume moves recompute both boxes' energies densely (the same
full-recompute discipline as `mc/npt.py`) — they are attempted at rate
p_volume, so the amortized cost stays O(cap) per step.

Exactness anchors (tests/test_gibbs.py):
  * ideal gas, volume moves off, V1 = V2: N1 ~ Binomial(N, 1/2) — mean
    and variance closed forms;
  * ideal gas with volume moves: <N1/V1> = <N2/V2>;
  * subcritical LJ: the boxes phase-separate and the chemical
    potentials (independent Widom insertions per box) agree — the
    defining property of the ensemble;
  * carried-energy drift vs dense recompute.

Min-image discipline: a volume move that would shrink either box below
2 r_cut is rejected outright (the `mc/npt.py` hard wall).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.mc.gcmc import make_slot_lj
from metropolismontecarlo_tpu.utils.activity import clear_slot2, set_slot2


class GibbsState(NamedTuple):
    com: jnp.ndarray       # (C, 2, cap, 3) slot positions per box
    active: jnp.ndarray    # (C, 2, cap) bool
    box: jnp.ndarray       # (C, 2) box edge lengths
    energy: jnp.ndarray    # (C, 2) carried per-box energies
    key: jnp.ndarray       # (C, 2) PRNG keys
    acc: jnp.ndarray       # (C, 3) accepted [disp, volume, transfer]
    att: jnp.ndarray       # (C, 3) attempted


def make_gibbs(system, params, capacity, dv_max=0.05, dtype=jnp.float64):
    """Build the Gibbs-ensemble step/energy functions.

    dv_max: volume-transfer half-width as a fraction of TOTAL volume.
    Returns (init, run_steps, full_energy); see `GibbsEnsemble`.
    """
    beta = jnp.asarray(1.0 / params.temperature, dtype)
    p_t = float(params.p_translate)
    p_v = float(params.p_volume)
    cap = int(capacity)
    rc = float(params.r_cut)
    site_energy, full_energy_one, nth_active, lrc_g = make_slot_lj(
        system, params, cap, dtype)

    # volume moves follow the mc/npt.py discipline: a DETERMINISTIC
    # attempt cycle (one volume attempt every round(1/p_volume) steps,
    # the same schedule for every chain) instead of per-step Bernoulli
    # draws.  A branchless per-step volume attempt would trace the
    # O(cap^2) dense recompute into EVERY step (under vmap, lax.cond
    # runs both branches), making each step ~cap x the cost of a
    # displacement; the static cycle keeps the recompute only where it
    # executes.  Sequential mixtures of reversible kernels remain valid
    # MC.  Within the cheap steps, displacement is chosen with the
    # conditional probability p_t / (1 - p_v).
    p_disp = p_t / (1.0 - p_v) if p_v < 1.0 else 1.0

    def _cheap_step(carry, _):
        """Displacement or particle transfer (O(cap) each)."""
        com, active, box, e, key, acc, att = carry
        key, k = jax.random.split(key)
        k_move, k_box, k_sel, k_pos, k_acc = jax.random.split(k, 5)
        n = jnp.sum(active.astype(jnp.int32), axis=1)          # (2,)
        mt = jnp.where(
            jax.random.uniform(k_move, dtype=dtype) < p_disp, 0, 2)
        u = jax.random.uniform(k_acc, dtype=dtype)
        u_sel = jax.random.uniform(k_sel, dtype=dtype)
        v = box**3
        nf = n.astype(dtype)

        # --- displacement in a random box -------------------------------
        b = jax.random.bernoulli(k_box).astype(jnp.int32)      # box pick
        idx_b = nth_active(active[b],
                           jnp.floor(u_sel * n[b]).astype(jnp.int32))
        u_old_b = site_energy(com[b], active[b], box[b], com[b, idx_b],
                              idx_b)
        # statically skipped in transfer-only builds;
        # u_old_b stays — the transfer source term reuses it
        move_on = p_disp > 0.0
        if move_on:
            disp = (jax.random.uniform(k_pos, (3,), dtype) - 0.5) \
                * params.dr_max
            new_pos = (com[b, idx_b] + disp) % box[b]
            u_new_b = site_energy(com[b], active[b], box[b], new_pos,
                                  idx_b)
            ok_t = (mt == 0) & (n[b] > 0) \
                & (u < jnp.exp(-beta * (u_new_b - u_old_b)))
        else:
            ok_t = jnp.asarray(False)

        # --- particle transfer s -> d -----------------------------------
        s = b                                                  # same bit
        d = 1 - s
        idx_s = idx_b
        u_rm = u_old_b
        pos_d = jax.random.uniform(k_pos, (3,), dtype) * box[d]
        u_in = site_energy(com[d], active[d], box[d], pos_d, -1)
        slot_d = jnp.argmax(~active[d])
        # per-box LJ tail deltas (U_lrc = g(box) N^2; mc/gcmc.py):
        # insertion into d gains g_d(2N_d+1), deletion from s gains
        # -g_s(2N_s-1) — box-dependent, so they do NOT cancel
        if lrc_g is not None:
            dl_in = lrc_g(box[d]) * (2.0 * nf[d] + 1.0)
            dl_rm = lrc_g(box[s]) * (-2.0 * nf[s] + 1.0)
        else:
            dl_in = dl_rm = jnp.zeros((), dtype)
        a_x = nf[s] * v[d] / ((nf[d] + 1.0) * v[s]) \
            * jnp.exp(-beta * (u_in + dl_in - u_rm + dl_rm))
        ok_x = (mt == 2) & (n[s] > 0) & (n[d] < cap) & (u < a_x)

        # --- apply (mutually exclusive branches) ------------------------
        if move_on:
            com = com.at[b, idx_b].set(jnp.where(ok_t, new_pos,
                                                 com[b, idx_b]))
            e = e.at[b].add(jnp.where(ok_t, u_new_b - u_old_b, 0.0))
        com = com.at[d, slot_d].set(jnp.where(ok_x, pos_d,
                                              com[d, slot_d]))
        # one-hot where-selects, never bool scatters (utils/activity.py:
        # the bool-scatter hazard)
        active = set_slot2(active, d, slot_d, ok_x)
        active = clear_slot2(active, s, idx_s, ok_x)
        e = e.at[d].add(jnp.where(ok_x, u_in + dl_in, 0.0))
        e = e.at[s].add(jnp.where(ok_x, -u_rm + dl_rm, 0.0))

        a_row = jnp.stack([ok_t, jnp.zeros((), bool), ok_x]) \
            .astype(jnp.int32)
        t_row = (jnp.arange(3) == mt).astype(jnp.int32)
        return (com, active, box, e, key, acc + a_row, att + t_row), None

    def _vol_step(carry):
        """Volume transfer (dense recompute of both boxes)."""
        com, active, box, e, key, acc, att = carry
        key, k = jax.random.split(key)
        k_pos, k_acc = jax.random.split(k)
        n = jnp.sum(active.astype(jnp.int32), axis=1)
        nf = n.astype(dtype)
        v = box**3
        dv = (jax.random.uniform(k_pos, dtype=dtype) - 0.5) * 2.0 \
            * dv_max * jnp.sum(v)
        v_new = v + jnp.stack([dv, -dv])
        box_new = jnp.cbrt(v_new)
        legal = jnp.all(box_new > 2.0 * rc)
        scale = jnp.where(legal, box_new / box, 1.0)
        com_v = com * scale[:, None, None]
        e_v = jax.vmap(full_energy_one)(com_v, active,
                                        jnp.where(legal, box_new, box))
        log_a_v = jnp.sum(nf * jnp.log(jnp.where(legal, v_new / v, 1.0))) \
            - beta * jnp.sum(e_v - e)
        u = jax.random.uniform(k_acc, dtype=dtype)
        ok_v = legal & (jnp.log(jnp.maximum(u, 1e-300)) < log_a_v)

        com = jnp.where(ok_v, com_v, com)
        box = jnp.where(ok_v, box_new, box)
        e = jnp.where(ok_v, e_v, e)
        acc = acc.at[1].add(ok_v.astype(jnp.int32))
        att = att.at[1].add(1)
        return (com, active, box, e, key, acc, att)

    period = int(round(1.0 / p_v)) if p_v > 0 else 0

    def _run_chain(com, active, box, e, key, acc, att, n_steps):
        carry = (com, active, box, e, key, acc, att)
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
        return jax.vmap(jax.vmap(full_energy_one))(state.com,
                                                   state.active,
                                                   state.box)

    from functools import partial

    @partial(jax.jit, static_argnums=1)
    def run_steps(state, n_steps):
        out = jax.vmap(_run_chain, in_axes=(0,) * 7 + (None,))(
            state.com, state.active, state.box, state.energy, state.key,
            state.acc, state.att, n_steps)
        return GibbsState(*out)

    def init(key, boxes, n_init, n_chains):
        """boxes (2,) edge lengths; n_init (2,) actives per box."""
        from metropolismontecarlo_tpu.io.configs import cubic_lattice
        n_init = np.asarray(n_init, np.int64)
        if np.any(n_init > cap):
            raise ValueError("n_init exceeds capacity")
        keys = jax.random.split(jnp.asarray(key), n_chains)
        # lattice starts per box (see mc/gcmc.py: random placement seeds
        # overlapped pairs that break the f64 drift invariant)
        lat = jnp.stack([jnp.asarray(cubic_lattice(cap, float(b)), dtype)
                         for b in np.asarray(boxes)])      # (2, cap, 3)
        com = jnp.broadcast_to(lat[None], (n_chains, 2, cap, 3))
        active = jnp.broadcast_to(
            jnp.arange(cap)[None, :] < jnp.asarray(n_init)[:, None],
            (n_chains, 2, cap))
        state = GibbsState(
            com=com, active=active,
            box=jnp.broadcast_to(jnp.asarray(boxes, dtype), (n_chains, 2)),
            energy=jnp.zeros((n_chains, 2), dtype), key=keys,
            acc=jnp.zeros((n_chains, 3), jnp.int32),
            att=jnp.zeros((n_chains, 3), jnp.int32))
        return state._replace(energy=full_energy(state))

    # per-box Widom insertions for the mu-equality diagnostic
    @partial(jax.jit, static_argnums=2)
    def widom_boltzmann(state, key, n_insertions):
        """(C, 2) mean exp(-beta dU_test) per box (overlaps floored)."""
        def one(com, active, box, k):
            pos = jax.random.uniform(k, (n_insertions, 3), dtype) * box
            du = jax.vmap(lambda p: site_energy(com, active, box, p, -1)
                          )(pos)
            return jnp.mean(jnp.exp(-beta * du))

        C = state.com.shape[0]
        ks = jax.random.split(jnp.asarray(key), C * 2).reshape(C, 2, 2)
        return jax.vmap(jax.vmap(one))(state.com, state.active,
                                       state.box, ks)

    return init, run_steps, full_energy, widom_boltzmann


class GibbsEnsemble:
    """Driver wrapper: blocks with the drift invariant and phase stats.

    >>> g = GibbsEnsemble(lj_system(1), params, capacity=256)
    >>> st = g.init(key, boxes=(9.0, 9.0), n_init=(128, 128), n_chains=16)
    >>> st, stats = g.run_block(st, 20_000)
    """

    def __init__(self, system, params, capacity, dv_max=0.05,
                 dtype=jnp.float64):
        self.params = params
        self.capacity = int(capacity)
        (self._init, self.run_steps, self.full_energy,
         self.widom_boltzmann) = make_gibbs(system, params, capacity,
                                            dv_max, dtype)

    def init(self, key, boxes, n_init, n_chains):
        return self._init(key, boxes, n_init, n_chains)

    def run_block(self, state, n_steps, drift_tol=None):
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        e = self.full_energy(state)
        # both-endpoint drift scale (see mc/gcmc_mol.MolGCMC.run_block)
        scale = jnp.maximum(jnp.maximum(jnp.abs(e), jnp.abs(e_start)),
                            1.0)
        drift = jnp.max(jnp.abs(e - state.energy) / scale)
        n = jnp.sum(state.active, axis=2)                    # (C, 2)
        rho = n / state.box**3
        ratio = (state.acc - acc0) / jnp.maximum(state.att - att0, 1)
        # per-chain phase split: the DENSER box of each chain is its
        # liquid (boxes can swap roles chain-to-chain)
        rho_np = np.asarray(rho, np.float64)
        stats = {
            "n_mean": [float(x) for x in np.asarray(n).mean(axis=0)],
            "rho_liq": float(rho_np.max(axis=1).mean()),
            "rho_vap": float(rho_np.min(axis=1).mean()),
            "full_frac": float(jnp.mean((n >= self.capacity)
                                        .astype(jnp.float64))),
            "acc_disp": float(jnp.mean(ratio[:, 0])),
            "acc_vol": float(jnp.mean(ratio[:, 1])),
            "acc_transfer": float(jnp.mean(ratio[:, 2])),
            "drift_max_rel": float(drift),
        }
        if drift_tol is not None:
            assert stats["drift_max_rel"] < drift_tol, stats
        return state._replace(energy=e), stats
