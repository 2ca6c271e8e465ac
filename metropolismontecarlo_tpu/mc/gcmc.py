"""Grand-canonical (muVT) Monte Carlo for the monatomic LJ fluid.

Beyond-parity ensemble app (the reference is NVT-only; its own apps are
the monatomic/poly/Ewald trio): insertion/deletion/displacement moves at
fixed activity

    z = exp(beta mu) / Lambda^3     (Lambda = 1 in reduced units,
                                     so beta mu = ln z)

with the textbook acceptance rules (Frenkel & Smit ch. 5, alg. 12-13;
Adams 1975):

    insert:  min[1, z V / (N + 1) exp(-beta dU)]
    delete:  min[1, N / (z V)     exp(-beta dU)]

Data-parallel design: a FIXED capacity of molecule slots per chain with a
per-chain activity mask (static shapes — no dynamic N anywhere), moves
batched over chains by vmap, the whole step loop a `lax.scan`, and
accept/reject by where-selects only.  Slot selection among the N active
(or first-free) slots is a cumsum/argmax scan over the mask, not a
gather of dynamic length.  The chain ensemble gives the N-histogram in
one shot — each chain is an independent muVT sample.

Exactness anchors (tests/test_gcmc.py):
  * ideal gas (eps = 0): N ~ Poisson(z V) — mean AND variance;
  * interacting LJ: beta mu_ex = ln(z / <rho>) must match the Widom
    machinery (`mc/widom.py`, an independent implementation) evaluated
    at the sampled density;
  * carried-energy drift vs dense recompute (the framework invariant).

Capacity truncation: states with N = capacity reject further insertions;
choose capacity >> z V (Poisson tail ~ exp(-capacity ln(capacity/zV)))
so truncation is below statistical noise.  `run_block` reports
`full_frac` so saturation is observable, never silent.

Model notes: cut (optionally linearly shifted) LJ only.  `use_lrc=True`
(unshifted only) adds the standard tail correction U_lrc = g(V) N^2 to
the sampled potential: since it is QUADRATIC in N, every exchange delta
is the closed form g*((N+dn)^2 - N^2) — affine in N — entering the
insertion/deletion acceptance, the carried energy, and the dense
recompute consistently (drift-gated).  The reference carries tail
corrections only in NVT (reference `Ewald/energy.jl:514-614`);
here they extend to every fluctuating-N ensemble.  Exact anchor: the
mean-field quadrature gate in tests/test_lrc_exchange.py.  Single
species, P = 1 (`models/monatomic.lj_system`).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.ops.pbc import min_image
from metropolismontecarlo_tpu.utils.activity import clear_slot, set_slot


class GCMCState(NamedTuple):
    com: jnp.ndarray       # (C, cap, 3) slot positions (junk where inactive)
    active: jnp.ndarray    # (C, cap) bool
    box: jnp.ndarray       # (C,)
    energy: jnp.ndarray    # (C,) carried total potential energy
    key: jnp.ndarray       # (C, 2) per-chain PRNG keys
    acc: jnp.ndarray       # (C, 3) accepted [trans, insert, delete]
    att: jnp.ndarray       # (C, 3) attempted [trans, insert, delete]


def _lj_coeffs(system, params, dtype):
    if system.atoms_per_mol != 1 or len(system.species_slices) != 1:
        raise ValueError("GCMC app supports single-species monatomic "
                         "systems (models/monatomic.lj_system)")
    eps = float(np.asarray(system.eps_table)[0, 0])
    sig = float(np.asarray(system.sig_table)[0, 0])
    lam1 = lam2 = 0.0
    if params.lj_shift == "linear":
        from metropolismontecarlo_tpu.ops.lj import _shift_coeffs
        l1, l2 = _shift_coeffs(np.asarray([params.r_cut / sig]))
        lam1, lam2 = float(l1[0]), float(l2[0]) / sig
    return (jnp.asarray(eps, dtype), jnp.asarray(sig**2, dtype),
            jnp.asarray(lam1, dtype), jnp.asarray(lam2, dtype))


def make_slot_lj(system, params, capacity, dtype):
    """Masked-slot LJ energy closures shared by the muVT and Gibbs apps.

    Returns (site_energy, full_energy_one, nth_active, lrc_g):
      site_energy(com (cap,3), active (cap,), box, pos (3,), exclude)
          -> energy of one site with every active slot != exclude;
      full_energy_one(com, active, box) -> total active-pair energy
          (+ the tail term g(box) N^2 when LRC is on);
      nth_active(mask, n_idx) -> slot index of the (n_idx+1)-th True;
      lrc_g — None when LRC is off (LRC-off builds stay bit-identical),
          else box -> g with U_lrc = g N^2 (ops/tail.mol_tail_coeff);
          exchange deltas are then g*((N+dn)^2 - N^2), affine in N.
    """
    eps, sig2, lam1, lam2 = _lj_coeffs(system, params, dtype)
    rc2 = jnp.asarray(params.r_cut**2, dtype)
    cap = int(capacity)
    floor = jnp.asarray(1e-4, dtype)
    shifted = params.lj_shift == "linear"

    lrc_g = None
    if params.use_lrc and not shifted:
        from metropolismontecarlo_tpu.ops import tail as tail_ops
        c_mm = tail_ops.mol_tail_coeff(
            [1.0], [1.0], np.asarray(system.eps_table)[:1, :1],
            np.asarray(system.sig_table)[:1, :1], params.r_cut)

        def lrc_g(box):     # noqa: F811
            return jnp.asarray(tail_ops.LRC_PREFACTOR * c_mm, dtype) \
                / box**3

    def _pair_pot(d2, mask):
        d2s = jnp.where(mask, jnp.maximum(d2, floor), jnp.ones((), dtype))
        s2 = sig2 / d2s
        s6 = s2 * s2 * s2
        pot = 4.0 * eps * (s6 * s6 - s6)
        if shifted:
            pot = pot + eps * (lam1 + lam2 * jnp.sqrt(d2s))
        return jnp.where(mask, pot, 0.0)

    def site_energy(com, active, box, pos, exclude):
        dr = min_image(pos[None, :] - com, box)
        d2 = jnp.sum(dr * dr, axis=-1)
        mask = active & (d2 < rc2) & (jnp.arange(cap) != exclude)
        return jnp.sum(_pair_pot(d2, mask))

    def full_energy_one(com, active, box):
        dr = min_image(com[:, None, :] - com[None, :, :], box)
        d2 = jnp.sum(dr * dr, axis=-1)
        pair = active[:, None] & active[None, :] & (d2 < rc2)
        iu = jnp.triu(jnp.ones((cap, cap), bool), k=1)
        e = jnp.sum(_pair_pot(d2, pair & iu))
        if lrc_g is not None:
            nf = jnp.sum(active.astype(dtype))
            e = e + lrc_g(box) * nf * nf
        return e

    def nth_active(mask, n_idx):
        c = jnp.cumsum(mask.astype(jnp.int32))
        return jnp.argmax(c >= n_idx + 1)

    return site_energy, full_energy_one, nth_active, lrc_g


def make_gcmc(system, params, activity, capacity, dtype=jnp.float64):
    """Build the muVT step/energy functions.

    activity: scalar, or a (n_chains,) ACTIVITY LADDER — each chain
    samples its own muVT ensemble (the grand-canonical analog of the
    per-chain pressure ladders, `mc/npt.py`): one compiled run covers a
    whole z-scan, and densely spaced rungs give `mc/mbar.
    reweight_activity_mbar` the P(N) overlap it needs to bridge between
    them.  Chains are independent, so a ladder costs nothing beyond the
    scalar run.

    Returns (init, run_steps, full_energy):
      init(key, box, n_init, n_chains) -> GCMCState (lattice initial
          placement of n_init actives per chain);
      run_steps(state, n_steps) -> GCMCState (jitted scan; one
          displacement-or-exchange attempt per step);
      full_energy(state) -> (C,) dense masked recompute (drift anchor).
    """
    beta = jnp.asarray(1.0 / params.temperature, dtype)
    z_arr = jnp.asarray(activity, dtype)
    if z_arr.ndim not in (0, 1):
        raise ValueError("activity must be a scalar or a (n_chains,) "
                         "ladder")
    p_t = float(params.p_translate)
    cap = int(capacity)
    _site_energy, _full_energy_one, _nth_active, _lrc_g = make_slot_lj(
        system, params, cap, dtype)

    def _one_step(carry, _):
        com, active, box, e, key, acc, att, z = carry
        key, k = jax.random.split(key)
        k_move, k_sel, k_pos, k_acc = jax.random.split(k, 4)
        n = jnp.sum(active.astype(jnp.int32))
        u_move = jax.random.uniform(k_move, dtype=dtype)
        # move type: 0 = displace, 1 = insert, 2 = delete (insert and
        # delete attempted with equal probability, as the acceptance
        # rules require)
        mt = jnp.where(u_move < p_t, 0,
                       jnp.where(u_move < p_t + 0.5 * (1.0 - p_t), 1, 2))

        # shared slot pick among the N active (displace & delete)
        u_sel = jax.random.uniform(k_sel, dtype=dtype)
        idx = _nth_active(active, jnp.floor(u_sel * n).astype(jnp.int32))
        u_old = _site_energy(com, active, box, com[idx], idx)

        # displacement proposal (reference +-dr/2 convention);
        # statically skipped in exchange-only builds (p_translate = 0)
        move_on = p_t > 0.0
        if move_on:
            disp = (jax.random.uniform(k_pos, (3,), dtype) - 0.5) \
                * params.dr_max
            new_pos = (com[idx] + disp) % box
            u_new = _site_energy(com, active, box, new_pos, idx)

        # insertion proposal at a uniform position, first free slot
        pos_i = jax.random.uniform(k_pos, (3,), dtype) * box
        u_ins = _site_energy(com, active, box, pos_i, -1)
        slot = jnp.argmax(~active)
        full = n >= cap

        vol = box**3
        nf = n.astype(dtype)
        # LJ tail-correction deltas (affine in N, see make_slot_lj);
        # statically zero-cost when LRC is off
        if _lrc_g is not None:
            g = _lrc_g(box)
            dl_i = g * (2.0 * nf + 1.0)
            dl_d = g * (-2.0 * nf + 1.0)
        else:
            dl_i = dl_d = jnp.zeros((), dtype)
        u = jax.random.uniform(k_acc, dtype=dtype)
        if move_on:
            ok_t = (mt == 0) & (n > 0) \
                & (u < jnp.exp(-beta * (u_new - u_old)))
        else:
            ok_t = jnp.asarray(False)
        ok_i = (mt == 1) & ~full & (
            u < z * vol / (nf + 1.0) * jnp.exp(-beta * (u_ins + dl_i)))
        ok_d = (mt == 2) & (n > 0) & (
            u < nf / (z * vol) * jnp.exp(beta * u_old - beta * dl_d))

        if move_on:
            com = com.at[idx].set(jnp.where(ok_t, new_pos, com[idx]))
            e = e + jnp.where(ok_t, u_new - u_old, 0.0)
        com = com.at[slot].set(jnp.where(ok_i, pos_i, com[slot]))
        # activity updates are one-hot WHERE-SELECTS, never dynamic
        # scatters: an XLA backend was caught DROPPING a bool scatter
        # here (utils/activity.py)
        active = set_slot(active, slot, ok_i)
        active = clear_slot(active, idx, ok_d)
        e = e + jnp.where(ok_i, u_ins + dl_i, 0.0) \
              + jnp.where(ok_d, -u_old + dl_d, 0.0)
        a_row = jnp.stack([ok_t, ok_i, ok_d]).astype(jnp.int32)
        t_row = (jnp.arange(3) == mt).astype(jnp.int32)
        return (com, active, box, e, key, acc + a_row, att + t_row,
                z), None

    def _run_chain(com, active, box, e, key, acc, att, z, n_steps):
        carry = (com, active, box, e, key, acc, att, z)
        carry, _ = jax.lax.scan(_one_step, carry, None, length=n_steps)
        return carry[:7]

    @jax.jit
    def full_energy(state):
        return jax.vmap(_full_energy_one)(state.com, state.active,
                                          state.box)

    from functools import partial

    z_axis = 0 if z_arr.ndim == 1 else None

    @partial(jax.jit, static_argnums=1)
    def run_steps(state, n_steps):
        out = jax.vmap(_run_chain, in_axes=(0,) * 7 + (z_axis, None))(
            state.com, state.active, state.box, state.energy, state.key,
            state.acc, state.att, z_arr, n_steps)
        return GCMCState(out[0], out[1], out[2], out[3], out[4],
                         out[5], out[6])

    def init(key, box, n_init, n_chains):
        if n_init > cap:
            raise ValueError("n_init exceeds capacity")
        if z_arr.ndim == 1 and z_arr.shape[0] != n_chains:
            raise ValueError(
                f"activity ladder has {z_arr.shape[0]} rungs but "
                f"n_chains={n_chains} (one activity per chain)")
        keys = jax.random.split(jnp.asarray(key), n_chains)
        # lattice start, NOT uniform random: random placement seeds
        # overlapped pairs whose floored ~1e12+ energies later cancel
        # imperfectly against the carried total (observed 5e-7 drift in
        # f64); a lattice keeps every pair energy O(1) so the drift
        # invariant holds from step 0
        from metropolismontecarlo_tpu.io.configs import cubic_lattice
        lat = jnp.asarray(cubic_lattice(cap, box), dtype)
        com = jnp.broadcast_to(lat[None], (n_chains, cap, 3))
        active = jnp.broadcast_to(jnp.arange(cap) < n_init,
                                  (n_chains, cap))
        boxes = jnp.full((n_chains,), box, dtype)
        state = GCMCState(
            com=com, active=active, box=boxes,
            energy=jnp.zeros((n_chains,), dtype), key=keys,
            acc=jnp.zeros((n_chains, 3), jnp.int32),
            att=jnp.zeros((n_chains, 3), jnp.int32))
        return state._replace(energy=full_energy(state))

    return init, run_steps, full_energy


def n_counts(state, capacity):
    """Pooled N-histogram over chains: (capacity+1,) counts of the
    current per-chain molecule numbers.  Accumulate across blocks to
    build P(N) for `reweight_activity`.  Works for both the monatomic
    (GCMCState) and molecular (MolGCMCState) apps."""
    n = np.asarray(jnp.sum(state.active, axis=-1), np.int64).ravel()
    return np.bincount(n, minlength=int(capacity) + 1)


def reweight_activity(hist, z0, z_new):
    """Exact muVT histogram reweighting in the activity.

    P_z(N) ~ z^N Q(N, V, T), so a histogram sampled at z0 predicts any
    nearby activity without new simulation:

        P_z'(N) ~ P_z0(N) (z'/z0)^N

    (exact for activity changes at fixed T, V — temperature reweighting
    would need the joint (N, U) histogram).  Returns a dict with
    n_mean, n_var, and ess — the effective-sample fraction
    (sum w)^2 / (sum w^2 * total); small ess means z_new is outside the
    sampled N range and the estimate is extrapolation, not data.
    """
    hist = np.asarray(hist, np.float64)
    if hist.sum() <= 0.0:
        raise ValueError("empty N-histogram — accumulate n_counts over "
                         "at least one block before reweighting")
    if z0 <= 0.0 or z_new <= 0.0:
        raise ValueError("activities must be positive")
    n = np.arange(len(hist))
    logw = n * np.log(z_new / z0)
    logw -= logw[hist > 0].max()
    # mask empty bins BEFORE exponentiating: for a far-extrapolated
    # z_new their un-normalized logw can overflow exp and turn
    # 0 * inf into NaN
    logw = np.where(hist > 0, logw, -np.inf)
    w = hist * np.exp(logw)
    tot = w.sum()
    n_mean = float((n * w).sum() / tot)
    n_var = float((n * n * w).sum() / tot - n_mean**2)
    ess = float(tot**2 / ((hist * np.exp(logw) ** 2).sum() * hist.sum()))
    return {"n_mean": n_mean, "n_var": n_var, "ess": ess}


class GCMC:
    """Driver wrapper: blocks with the drift invariant and N statistics.

    `activity` may be a scalar or a (n_chains,) per-chain ladder (one
    z-scan in one compiled run; see `make_gcmc`).  Ladder runs read
    per-chain N from `jnp.sum(state.active, 1)` — the pooled `n_mean`
    in the block stats mixes rungs.

    >>> g = GCMC(lj_system(1), params, activity=0.05, capacity=128)
    >>> st = g.init(key, box=8.0, n_init=24, n_chains=256)
    >>> st, stats = g.run_block(st, 2000)
    """

    def __init__(self, system, params, activity, capacity,
                 dtype=jnp.float64):
        self.params = params
        self.capacity = int(capacity)
        self._init, self.run_steps, self.full_energy = make_gcmc(
            system, params, activity, capacity, dtype)

    def init(self, key, box, n_init, n_chains):
        return self._init(key, box, n_init, n_chains)

    def run_block(self, state, n_steps, drift_tol=None):
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        e = self.full_energy(state)
        # both-endpoint drift scale (see mc/gcmc_mol.MolGCMC.run_block)
        scale = jnp.maximum(jnp.maximum(jnp.abs(e), jnp.abs(e_start)),
                            1.0)
        drift = jnp.max(jnp.abs(e - state.energy) / scale)
        n = jnp.sum(state.active, axis=1)
        ratio = (state.acc - acc0) / jnp.maximum(state.att - att0, 1)
        stats = {
            "n_mean": float(jnp.mean(n.astype(jnp.float64))),
            "n_var": float(jnp.var(n.astype(jnp.float64))),
            "full_frac": float(jnp.mean((n >= self.capacity)
                                        .astype(jnp.float64))),
            "energy_mean": float(jnp.mean(e)),
            "acc_trans": float(jnp.mean(ratio[:, 0])),
            "acc_insert": float(jnp.mean(ratio[:, 1])),
            "acc_delete": float(jnp.mean(ratio[:, 2])),
            "drift_max_rel": float(drift),
        }
        if drift_tol is not None:
            assert stats["drift_max_rel"] < drift_tol, stats
        return state._replace(energy=e), stats
