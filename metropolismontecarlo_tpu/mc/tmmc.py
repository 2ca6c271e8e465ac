"""Transition-matrix Monte Carlo (TMMC): flat-histogram muVT and the
full macrostate free-energy profile ln Pi(N).

Plain GCMC (mc/gcmc.py) samples P(N) where the activity puts it — at a
subcritical temperature the vapor and liquid basins are separated by an
interfacial barrier of many kT and a single run never crosses it.  TMMC
(Fitzgerald, Picard & Silver 1999; Errington, J. Chem. Phys. 118, 9915
(2003)) solves this with two coupled ideas:

  * every insertion/deletion ATTEMPT deposits its UNBIASED acceptance
    probability into a collection matrix C(N, dN) — infinitely more
    data per step than accept/reject outcomes, and independent of any
    sampling bias in force;
  * the macrostate transition probabilities P(N -> N') =
    C(N, dN) / sum_dN' C(N, dN') give the free-energy profile through
    detailed balance,  ln Pi(N+1) - ln Pi(N) =
    ln P(N -> N+1) - ln P(N+1 -> N),  and a bias eta(N) = -ln Pi_est(N)
    applied to the ACCEPTANCE (never the bookkeeping) flattens the
    sampled N-histogram so the walker diffuses freely across the
    barrier.

One run at one activity then yields ln Pi(N) over the WHOLE N range;
reweighting ln Pi_z'(N) = ln Pi(N) + N ln(z'/z0) gives every other
activity, and the equal-basin-weight condition locates vapor-liquid
coexistence (`coexistence`).  This is the method behind the NIST SRSW
reference coexistence data — the estimator side is host NumPy, the
sampler is the same fixed-capacity masked-slot design as mc/gcmc.py
(static shapes, scan over steps, vmap over chains, where-select
acceptance; chains are independent walkers pooling into one C).

Exactness anchors (tests/test_tmmc.py):
  * ideal gas: ln Pi(N) = N ln(zV) - ln N! exactly;
  * bias invariance: C is accumulated from unbiased probabilities, so
    ANY eta must leave the ln Pi estimate unchanged (only its sampling
    efficiency differs);
  * interacting LJ: P(N) from ln Pi matches a plain-GCMC histogram at
    the same state point;
  * the carried-energy drift invariant (the framework-wide anchor).

Reference anchor: the reference has no ensemble machinery at all
(SURVEY §2; its apps are NVT-only — `Ewald/main.jl`).
"""

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.mc.gcmc import GCMCState, make_slot_lj
from metropolismontecarlo_tpu.utils.activity import clear_slot, set_slot


def make_tmmc(system, params, activity, capacity, dtype=jnp.float64):
    """Build the biased-muVT step functions with collection-matrix
    accumulation.

    Returns (init, run_steps, full_energy):
      init(key, box, n_init, n_chains) -> GCMCState;
      run_steps(state, eta, n_steps) -> (GCMCState, cmat, uhist) where
          eta is the (cap+1,) bias table applied to exchange acceptance,
          cmat is the (C, cap+1, 3) per-chain collection matrix of this
          call — columns [stay, up, down] — and uhist the (C, cap+1, 3)
          per-slice canonical energy moments [count, sum E, sum E^2];
          both freshly zeroed each call so the host accumulates in f64;
      full_energy(state) -> (C,) dense masked recompute.

    Sampling distribution: pi_biased(x) ~ pi_muVT(x) exp(eta(N(x))), so
    exchange acceptance gains a factor exp(eta(N') - eta(N));
    displacements (N unchanged) are untouched.  The collection matrix
    records min(1, raw ratio) WITHOUT eta — the C statistics estimate
    the unbiased chain's transition probabilities regardless of eta
    (Errington 2003, eq. 6-8).
    """
    beta = jnp.asarray(1.0 / params.temperature, dtype)
    z = jnp.asarray(activity, dtype)
    p_t = float(params.p_translate)
    cap = int(capacity)
    site_energy, full_energy_one, nth_active, lrc_g = make_slot_lj(
        system, params, cap, dtype)

    def _one_step(carry, _):
        com, active, box, e, key, acc, att, cmat, uhist, eta = carry
        key, k = jax.random.split(key)
        k_move, k_sel, k_pos, k_acc = jax.random.split(k, 4)
        n = jnp.sum(active.astype(jnp.int32))
        u_move = jax.random.uniform(k_move, dtype=dtype)
        mt = jnp.where(u_move < p_t, 0,
                       jnp.where(u_move < p_t + 0.5 * (1.0 - p_t), 1, 2))

        u_sel = jax.random.uniform(k_sel, dtype=dtype)
        idx = nth_active(active, jnp.floor(u_sel * n).astype(jnp.int32))
        u_old = site_energy(com, active, box, com[idx], idx)

        # statically skipped in exchange-only builds;
        # u_old stays — the deletion deposit needs it every step
        move_on = p_t > 0.0
        if move_on:
            disp = (jax.random.uniform(k_pos, (3,), dtype) - 0.5) \
                * params.dr_max
            new_pos = (com[idx] + disp) % box
            u_new = site_energy(com, active, box, new_pos, idx)

        pos_i = jax.random.uniform(k_pos, (3,), dtype) * box
        u_ins = site_energy(com, active, box, pos_i, -1)
        slot = jnp.argmax(~active)
        full = n >= cap

        vol = box**3
        nf = n.astype(dtype)
        # unbiased acceptance probabilities (the collection-matrix
        # entries); a full chain's insertion is a hard reject — its
        # probability in the CAPPED ensemble is 0, and ln Pi is only
        # read below the cap
        # LJ tail-correction deltas (affine in N; see mc/gcmc.py) enter
        # the UNBIASED ratios, so the collection-matrix deposits carry
        # them too; statically zero-cost when LRC is off
        if lrc_g is not None:
            g = lrc_g(box)
            dl_i = g * (2.0 * nf + 1.0)
            dl_d = g * (-2.0 * nf + 1.0)
        else:
            dl_i = dl_d = jnp.zeros((), dtype)
        r_i = z * vol / (nf + 1.0) * jnp.exp(-beta * (u_ins + dl_i))
        r_d = nf / (z * vol) * jnp.exp(beta * u_old - beta * dl_d)
        pa_i = jnp.where(full, 0.0, jnp.minimum(1.0, r_i))
        pa_d = jnp.where(n > 0, jnp.minimum(1.0, r_d), 0.0)

        # biased acceptance: multiply the RAW ratio by exp(deta); the
        # indices are clamped, but the full / n==0 guards reject those
        # edges before eta is ever used
        eta_n = eta[n]
        deta_i = eta[jnp.minimum(n + 1, cap)] - eta_n
        deta_d = eta[jnp.maximum(n - 1, 0)] - eta_n
        u = jax.random.uniform(k_acc, dtype=dtype)
        if move_on:
            ok_t = (mt == 0) & (n > 0) \
                & (u < jnp.exp(-beta * (u_new - u_old)))
        else:
            ok_t = jnp.asarray(False)
        ok_i = (mt == 1) & ~full & (u < r_i * jnp.exp(deta_i))
        ok_d = (mt == 2) & (n > 0) & (u < r_d * jnp.exp(deta_d))

        if move_on:
            com = com.at[idx].set(jnp.where(ok_t, new_pos, com[idx]))
            e = e + jnp.where(ok_t, u_new - u_old, 0.0)
        com = com.at[slot].set(jnp.where(ok_i, pos_i, com[slot]))
        # one-hot where-selects, never bool scatters (utils/activity.py:
        # the bool-scatter hazard)
        active = set_slot(active, slot, ok_i)
        active = clear_slot(active, idx, ok_d)
        e = e + jnp.where(ok_i, u_ins + dl_i, 0.0) \
              + jnp.where(ok_d, -u_old + dl_d, 0.0)
        a_row = jnp.stack([ok_t, ok_i, ok_d]).astype(jnp.int32)
        t_row = (jnp.arange(3) == mt).astype(jnp.int32)

        # Rao-Blackwellized collection-matrix deposit: both pa_i and
        # pa_d are computed every step anyway, so deposit the exact
        # expectation over the move-type choice (probabilities folded
        # in analytically) at EVERY step instead of the sampled type
        # only — removes the multinomial type-choice noise entirely.
        # For the ideal gas the deposits are deterministic per N, so
        # ln Pi is exact after a single visit (gated in tests).  The
        # one-hot row is a where-select add on the small (cap+1, 3)
        # table — no dynamic indexing.
        p_x = jnp.asarray(0.5 * (1.0 - p_t), dtype)
        up_v = p_x * pa_i
        dn_v = p_x * pa_d
        stay_v = 1.0 - up_v - dn_v
        row = (jnp.arange(cap + 1) == n).astype(dtype)
        cmat = cmat + row[:, None] * jnp.stack([stay_v, up_v, dn_v])
        # per-slice canonical energy moments (pre-move state, same row
        # convention as cmat): d ln Q_N / d beta = -<U>_N makes these
        # the temperature-extension data (see reweight_lnpi_temperature)
        uhist = uhist + row[:, None] * jnp.stack(
            [jnp.ones((), dtype), e, e * e])

        return (com, active, box, e, key, acc + a_row, att + t_row,
                cmat, uhist, eta), None

    def _run_chain(com, active, box, e, key, acc, att, eta, n_steps):
        cmat = jnp.zeros((cap + 1, 3), dtype)
        uhist = jnp.zeros((cap + 1, 3), dtype)
        carry = (com, active, box, e, key, acc, att, cmat, uhist, eta)
        carry, _ = jax.lax.scan(_one_step, carry, None, length=n_steps)
        return carry[:9]          # (..., cmat, uhist), eta dropped

    @jax.jit
    def full_energy(state):
        return jax.vmap(full_energy_one)(state.com, state.active,
                                         state.box)

    from functools import partial

    @partial(jax.jit, static_argnums=2)
    def run_steps(state, eta, n_steps):
        out = jax.vmap(_run_chain,
                       in_axes=(0,) * 7 + (None, None))(
            state.com, state.active, state.box, state.energy, state.key,
            state.acc, state.att, jnp.asarray(eta, dtype), n_steps)
        new = GCMCState(out[0], out[1], out[2], out[3], out[4],
                        out[5], out[6])
        return new, out[7], out[8]

    def init(key, box, n_init, n_chains):
        """n_init: scalar, or (n_chains,) per-chain STRATIFIED starts —
        spreading walkers across the whole N range makes the collection
        matrix cover both basins from block 0 instead of waiting for a
        diffusive frontier (the difference between 0.5 and full
        coverage at strongly subcritical temperatures)."""
        n0 = np.asarray(n_init, np.int32)
        if np.any(n0 > cap):
            raise ValueError("n_init exceeds capacity")
        if n0.ndim == 1 and n0.shape[0] != n_chains:
            raise ValueError("per-chain n_init must have n_chains entries")
        keys = jax.random.split(jnp.asarray(key), n_chains)
        from metropolismontecarlo_tpu.io.configs import cubic_lattice
        lat = jnp.asarray(cubic_lattice(cap, box), dtype)
        com = jnp.broadcast_to(lat[None], (n_chains, cap, 3))
        active = (jnp.arange(cap)[None, :]
                  < jnp.asarray(n0).reshape(-1, 1 if n0.ndim else 1))
        active = jnp.broadcast_to(active, (n_chains, cap))
        boxes = jnp.full((n_chains,), box, dtype)
        state = GCMCState(
            com=com, active=active, box=boxes,
            energy=jnp.zeros((n_chains,), dtype), key=keys,
            acc=jnp.zeros((n_chains, 3), jnp.int32),
            att=jnp.zeros((n_chains, 3), jnp.int32))
        return state._replace(energy=full_energy(state))

    return init, run_steps, full_energy


def lnpi_from_cmat(cmat):
    """ln Pi(N) from a pooled collection matrix.

    cmat: (cap+1, 3) f64 — columns [stay, up, down] summed over chains
    and blocks.  Returns (lnpi, visited): lnpi (cap+1,) with
    lnpi[n_lo] = 0 on the largest contiguous visited range and -inf
    outside; visited (cap+1,) bool.  A macrostate counts as visited
    when it has attempt mass AND both links of the detailed-balance
    ratio into its neighbor are measured.
    """
    cmat = np.asarray(cmat, np.float64)
    cap1 = cmat.shape[0]
    rowsum = cmat.sum(axis=1)
    # P(N -> N+1) and P(N+1 -> N) both measured => the edge is usable
    with np.errstate(invalid="ignore", divide="ignore"):
        p_up = np.where(rowsum > 0, cmat[:, 1] / np.maximum(rowsum, 1e-300),
                        0.0)
        p_dn = np.where(rowsum > 0, cmat[:, 2] / np.maximum(rowsum, 1e-300),
                        0.0)
    edge = (p_up[:-1] > 0) & (p_dn[1:] > 0)
    if not edge.any():
        raise ValueError("collection matrix has no measured transitions — "
                         "run more steps before estimating ln Pi")
    # largest contiguous run of usable edges
    starts, lengths = [], []
    i = 0
    while i < edge.size:
        if edge[i]:
            j = i
            while j < edge.size and edge[j]:
                j += 1
            starts.append(i)
            lengths.append(j - i)
            i = j
        else:
            i += 1
    s = starts[int(np.argmax(lengths))]
    l = lengths[int(np.argmax(lengths))]
    lnpi = np.full(cap1, -np.inf)
    lnpi[s] = 0.0
    for n in range(s, s + l):
        lnpi[n + 1] = lnpi[n] + np.log(p_up[n]) - np.log(p_dn[n + 1])
    visited = np.isfinite(lnpi)
    return lnpi, visited


def bias_from_lnpi(lnpi):
    """eta = -ln Pi, extended flat beyond the visited range (clamped to
    the edge values) so unexplored macrostates are neither pushed away
    nor artificially favored."""
    lnpi = np.asarray(lnpi, np.float64)
    eta = -lnpi
    fin = np.isfinite(eta)
    if not fin.any():
        return np.zeros_like(eta)
    idx = np.where(fin)[0]
    eta[: idx[0]] = eta[idx[0]]
    eta[idx[-1] + 1:] = eta[idx[-1]]
    # gauge: eta(visited min) = 0 keeps the exp() arguments small
    return eta - eta[idx[0]]


def reweight_lnpi(lnpi, z0, z_new):
    """ln Pi at another activity: exact in z at fixed T, V."""
    n = np.arange(len(lnpi))
    out = np.asarray(lnpi, np.float64) + n * np.log(float(z_new) /
                                                    float(z0))
    fin = np.isfinite(out)
    return out - out[fin].max() if fin.any() else out


def _basin_stats(lnpi, n_sep=10, min_barrier=1.0):
    """Split a two-basin ln Pi at its interior minimum; return
    (ln W_vap, ln W_liq, N_vap, N_liq) — basin log-weights and
    basin-mean molecule numbers.

    A statistical ln Pi has many sub-kT noise wiggles, each technically
    a local max; accepting any of them lets the equal-weight solver
    latch onto a noise dimple near the global peak (observed: a
    T = 1.05 LJ run "found" basins at N = 160 and 166).  Guards:
      * a candidate second peak must be >= n_sep states from the global
        one and separated by an interior minimum >= min_barrier (kT)
        below BOTH peaks;
      * among qualifying candidates, pick the one with the DEEPEST
        separating valley (largest prominence of the lower peak), not
        the highest peak.  The true vapor-liquid interfacial barrier is
        many kT while noise dimples are ~1 kT, so ordering by peak
        height lets a dimple adjacent to the favored basin win whenever
        the reweighting tilt pushes the other basin's peak below it
        (observed: T = 1.0 with height ordering split the LIQUID at
        N = 165/181 instead of finding the vapor basin)."""
    fin = np.where(np.isfinite(lnpi))[0]
    sub = lnpi[fin]
    imax1, imax2, isplit = _find_split(sub, n_sep, min_barrier)
    n_grid = fin.astype(np.float64)

    def side(sl):
        w = sub[sl]
        m = w.max()
        lw = m + np.log(np.exp(w - m).sum())
        nm = float((n_grid[sl] * np.exp(w - m)).sum() /
                   np.exp(w - m).sum())
        return lw, nm

    lw_a, n_a = side(slice(0, isplit + 1))
    lw_b, n_b = side(slice(isplit + 1, sub.size))
    if n_a <= n_b:
        return lw_a, lw_b, n_a, n_b
    return lw_b, lw_a, n_b, n_a


def _find_split(sub, n_sep, min_barrier):
    """Locate the two basin peaks and the dividing minimum on a finite
    ln Pi segment; raises ValueError when single-basin.  Returns
    (imax1, imax2, isplit) indices into `sub`."""
    imax1 = int(np.argmax(sub))
    best_sig, imax2 = -np.inf, None
    for i in range(sub.size):
        if abs(i - imax1) < n_sep or not _is_local_max(sub, i):
            continue
        lo, hi = sorted((imax1, i))
        barrier = float(np.min(sub[lo:hi + 1]))
        sig = min(float(sub[i]), float(sub[imax1])) - barrier
        if sig >= min_barrier and sig > best_sig:
            best_sig, imax2 = sig, i
    if imax2 is None:
        raise ValueError("ln Pi is single-basin at this activity")
    lo, hi = sorted((imax1, imax2))
    isplit = lo + int(np.argmin(sub[lo:hi + 1]))
    return imax1, imax2, isplit


def _is_local_max(a, i):
    l = a[i - 1] if i > 0 else -np.inf
    r = a[i + 1] if i + 1 < a.size else -np.inf
    return a[i] >= l and a[i] >= r


def coexistence(lnpi, z0, volume, z_lo=None, z_hi=None, tol=1e-10,
                n_sep=10, min_barrier=1.0):
    """Vapor-liquid coexistence from ln Pi by equal basin weights.

    Bisect on ln z until the reweighted ln Pi has equal integrated
    probability in the two basins (Errington 2003).  n_sep/min_barrier
    are the `_basin_stats` noise guards.  Returns a dict: z_coex,
    rho_vap, rho_liq (basin-mean N / V), dlnw (residual weight
    imbalance), and lnpi_coex.
    """
    lnpi = np.asarray(lnpi, np.float64)
    z_lo = z_lo if z_lo is not None else z0 * 1e-3
    z_hi = z_hi if z_hi is not None else z0 * 1e3

    fin_n = np.where(np.isfinite(lnpi))[0]
    n_mid = 0.5 * (fin_n[0] + fin_n[-1])

    def imbalance(z):
        lp = reweight_lnpi(lnpi, z0, z)
        try:
            lw_v, lw_l, _, _ = _basin_stats(lp, n_sep, min_barrier)
        except ValueError:
            # a strong tilt destroys one basin's local max entirely:
            # peak at low N => vapor-only (z far too low), at high N
            # => liquid-only (z far too high)
            peak = fin_n[np.argmax(lp[fin_n])]
            return -np.inf if peak < n_mid else np.inf
        return lw_l - lw_v          # grows with z

    f_lo, f_hi = imbalance(z_lo), imbalance(z_hi)
    if not (f_lo < 0 < f_hi):
        raise ValueError(
            f"coexistence not bracketed in [{z_lo}, {z_hi}]: "
            f"imbalance {f_lo:.3g} .. {f_hi:.3g}")
    a, b = np.log(z_lo), np.log(z_hi)
    for _ in range(200):
        m = 0.5 * (a + b)
        if imbalance(np.exp(m)) < 0:
            a = m
        else:
            b = m
        if b - a < tol:
            break
    z_c = float(np.exp(0.5 * (a + b)))
    lp = reweight_lnpi(lnpi, z0, z_c)
    lw_v, lw_l, n_v, n_l = _basin_stats(lp, n_sep, min_barrier)
    return {
        "z_coex": z_c,
        "rho_vap": n_v / volume,
        "rho_liq": n_l / volume,
        "dlnw": float(lw_l - lw_v),
        "lnpi_coex": lp,
    }


def surface_tension(lnpi_coex, box, temperature, n_sep=10,
                    min_barrier=1.0):
    """Vapor-liquid surface tension from the ln Pi interfacial barrier
    (Binder, Phys. Rev. A 25, 1699 (1982)).

    At coexistence the minimum between the basins corresponds to a
    liquid slab spanning the box with TWO planar interfaces of area
    L^2, so the barrier height is their free-energy cost:

        beta F_barrier = (ln Pi_vap_peak + ln Pi_liq_peak)/2 - ln Pi_min
        gamma = kT * beta F_barrier / (2 L^2)

    Single-box estimate — the rigorous method extrapolates L -> inf
    (ln L / L^2 corrections), so expect ~10-20% finite-size deviation
    from the thermodynamic limit at L ~ 6 sigma.  Returns gamma in
    [energy]/[length]^2 (reduced LJ: epsilon/sigma^2).
    """
    lnpi = np.asarray(lnpi_coex, np.float64)
    fin = np.where(np.isfinite(lnpi))[0]
    sub = lnpi[fin]
    imax1, imax2, isplit = _find_split(sub, n_sep, min_barrier)
    df = 0.5 * (float(sub[imax1]) + float(sub[imax2])) - float(sub[isplit])
    area = 2.0 * float(box) ** 2
    return float(temperature) * df / area


class TMMC:
    """Driver wrapper: blocks of biased sampling with collection-matrix
    pooling (host f64) and self-tuned bias updates.

    >>> t = TMMC(lj_system(1), params, activity=0.03, capacity=192)
    >>> st = t.init(key, box=6.0, n_init=16, n_chains=256)
    >>> for _ in range(12):
    ...     st, stats = t.run_block(st, 4000)     # eta refreshed per block
    >>> res = coexistence(t.lnpi(), t.activity, 6.0**3)
    """

    def __init__(self, system, params, activity, capacity,
                 dtype=jnp.float64):
        self.params = params
        self.activity = float(activity)
        self.capacity = int(capacity)
        self._init, self._run_steps, self.full_energy = make_tmmc(
            system, params, activity, capacity, dtype)
        self.cmat = np.zeros((self.capacity + 1, 3), np.float64)
        self.uhist = np.zeros((self.capacity + 1, 3), np.float64)
        self.eta = np.zeros(self.capacity + 1, np.float64)

    def init(self, key, box, n_init, n_chains):
        return self._init(key, box, n_init, n_chains)

    def run_block(self, state, n_steps, drift_tol=None, update_bias=True):
        att0, acc0 = state.att, state.acc
        state, cmat, uhist = self._run_steps(state, self.eta, n_steps)
        self.cmat += np.asarray(cmat, np.float64).sum(axis=0)
        self.uhist += np.asarray(uhist, np.float64).sum(axis=0)
        e = self.full_energy(state)
        scale = jnp.maximum(jnp.abs(e), 1.0)
        drift = jnp.max(jnp.abs(e - state.energy) / scale)
        n = jnp.sum(state.active, axis=1)
        ratio = (state.acc - acc0) / jnp.maximum(state.att - att0, 1)
        visited_frac = float(np.mean(self.cmat.sum(axis=1) > 0))
        stats = {
            "n_mean": float(jnp.mean(n.astype(jnp.float64))),
            "n_min": int(jnp.min(n)),
            "n_max": int(jnp.max(n)),
            "visited_frac": visited_frac,
            "full_frac": float(jnp.mean((n >= self.capacity)
                                        .astype(jnp.float64))),
            "acc_trans": float(jnp.mean(ratio[:, 0])),
            "acc_insert": float(jnp.mean(ratio[:, 1])),
            "acc_delete": float(jnp.mean(ratio[:, 2])),
            "drift_max_rel": float(drift),
        }
        if drift_tol is not None:
            assert stats["drift_max_rel"] < drift_tol, stats
        if update_bias:
            try:
                lnpi, _ = lnpi_from_cmat(self.cmat)
                self.eta = bias_from_lnpi(lnpi)
            except ValueError:
                pass                      # not enough data yet
        return state._replace(energy=e), stats

    def reset_collection(self):
        """Burn-in discard.  TM deposits average the acceptance
        probability over the SAMPLED microstate distribution within each
        N-slice, so the estimator is only exact once that within-slice
        sampling is equilibrated — deposits from unequilibrated starts
        (e.g. stratified walkers still on their init lattice) pollute C
        permanently and can fabricate ln Pi structure at the frontier
        (observed: a rising edge spike at N = 178-182 that hijacked the
        T = 1.0 coexistence solve).  Call after the equilibration blocks
        to restart accumulation; the current bias eta is kept."""
        self.cmat[:] = 0.0
        if hasattr(self, "uhist"):
            self.uhist[:] = 0.0

    def lnpi(self):
        lnpi, _ = lnpi_from_cmat(self.cmat)
        return lnpi

    def u_moments(self):
        """Per-slice canonical energy moments: (<U>(N), var U(N)) over
        the sampled within-slice distribution; NaN where unvisited."""
        return u_moments(self.uhist)


def u_moments(uhist):
    uhist = np.asarray(uhist, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        cnt = uhist[:, 0]
        mean = np.where(cnt > 0, uhist[:, 1] / np.maximum(cnt, 1), np.nan)
        var = np.where(cnt > 1,
                       uhist[:, 2] / np.maximum(cnt, 1) - mean**2,
                       np.nan)
    return mean, np.maximum(var, 0.0)


def reweight_lnpi_temperature(lnpi, uhist, t_from, t_to,
                              second_order=True):
    """Extend ln Pi(N) to a nearby temperature from one run's per-slice
    energy moments.

    At fixed activity z, Pi(N) ~ z^N Q_N(beta) / N!, and
    d ln Q_N / d beta = -<U>_N,  d^2 ln Q_N / d beta^2 = var(U)_N, so

      ln Pi(N; b') = ln Pi(N; b) - db <U>_N + db^2/2 var(U)_N + O(db^3)

    with db = b' - b.  The same z label carries over (reweight_lnpi /
    coexistence then re-solve the new saturation activity), i.e. z is
    held FIXED across the extrapolation — mu shifts with T accordingly.

    Accuracy: exact for the ideal gas (moments vanish); for interacting
    systems the truncation error is O(db^3 <dU^3>) per slice — good for
    |dT|/T of a few percent (gated against a direct run in tests).
    var(U) needs f64 sampling (f32 E^2 accumulation loses the
    cancellation); pass second_order=False for f32-collected moments.

    Returns the extrapolated ln Pi, -inf where moments are missing.
    """
    lnpi = np.asarray(lnpi, np.float64)
    u_mean, u_var = u_moments(uhist)
    db = 1.0 / float(t_to) - 1.0 / float(t_from)
    out = lnpi - db * u_mean
    if second_order:
        # slices visited <= 1 time have no variance estimate — use 0
        # (first order) there rather than poisoning the state with NaN
        out = out + 0.5 * db * db * np.where(np.isfinite(u_var),
                                             u_var, 0.0)
    out = np.where(np.isfinite(lnpi) & np.isfinite(u_mean), out,
                   -np.inf)
    fin = np.isfinite(out)
    return out - out[fin].max() if fin.any() else out


class TMMCMol:
    """Flat-histogram muVT for RIGID MOLECULAR species: the TMMC
    estimator (collection matrix, self-tuned bias, ln Pi(N)) on top of
    the molecular-GCMC machinery (orientational insertions, carried
    Ewald structure factors, Rosenbluth k-trials) — vapor-liquid
    coexistence of molecular fluids (e.g. SPC/E water) from ONE biased
    run.  See `make_gcmc_mol(..., tmmc=True)` for the step function and
    `TMMC` for the estimator conventions; `coexistence`/
    `surface_tension` apply unchanged.

    >>> t = TMMCMol(spce_system(64), params, activity=1e-4)
    >>> st = t.init(key, 15.0, np.linspace(0, 60, 128).astype(int), 128)
    >>> for b in range(48):
    ...     st, stats = t.run_block(st, 2000)
    ...     if b == 11: t.reset_collection()      # burn-in discard
    >>> res = coexistence(t.lnpi(), t.activity, 15.0**3)
    """

    def __init__(self, system, params, activity, p_exchange=0.3,
                 dtype=jnp.float64, chunk=8, n_orient=1,
                 bias="orientation"):
        from metropolismontecarlo_tpu.mc.gcmc_mol import make_gcmc_mol
        self.params = params
        self.activity = float(activity)
        self.capacity = int(system.n_mol)
        self._init, self._run_steps, self.full_energy = make_gcmc_mol(
            system, params, activity, p_exchange, dtype, chunk, n_orient,
            bias, tmmc=True)
        self.cmat = np.zeros((self.capacity + 1, 3), np.float64)
        self.uhist = np.zeros((self.capacity + 1, 3), np.float64)
        self.eta = np.zeros(self.capacity + 1, np.float64)

    def init(self, key, box, n_init, n_chains):
        return self._init(key, box, n_init, n_chains)

    def run_block(self, state, n_steps, drift_tol=None, update_bias=True):
        att0, acc0 = state.att, state.acc
        e0 = state.energy
        state, cmat, uhist = self._run_steps(state, self.eta, n_steps)
        self.cmat += np.asarray(cmat, np.float64).sum(axis=0)
        self.uhist += np.asarray(uhist, np.float64).sum(axis=0)
        e, sf = self.full_energy(state)
        # drift scale: BOTH block endpoints — a biased walker can travel
        # the whole N range in one block (e.g. 70 waters -> 2), and the
        # f32 cancellation residue of that excursion is tiny relative to
        # the energies traversed but large relative to the near-zero
        # endpoint alone
        scale = jnp.maximum(jnp.maximum(jnp.abs(e), jnp.abs(e0)), 1.0)
        drift = jnp.max(jnp.abs(e - state.energy) / scale)
        sfac_err = jnp.max(jnp.abs(sf - state.sfac))
        n = jnp.sum(state.active, axis=1)
        ratio = (state.acc - acc0) / jnp.maximum(state.att - att0, 1)
        stats = {
            "n_mean": float(jnp.mean(n.astype(jnp.float64))),
            "n_min": int(jnp.min(n)),
            "n_max": int(jnp.max(n)),
            "visited_frac": float(np.mean(self.cmat.sum(axis=1) > 0)),
            "full_frac": float(jnp.mean((n >= self.capacity)
                                        .astype(jnp.float64))),
            "acc_trans": float(jnp.mean(ratio[:, 0])),
            "acc_rot": float(jnp.mean(ratio[:, 1])),
            "acc_insert": float(jnp.mean(ratio[:, 2])),
            "acc_delete": float(jnp.mean(ratio[:, 3])),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None:
            assert stats["drift_max_rel"] < drift_tol, stats
        if update_bias:
            try:
                lnpi, _ = lnpi_from_cmat(self.cmat)
                self.eta = bias_from_lnpi(lnpi)
            except ValueError:
                pass                      # not enough data yet
        return state._replace(energy=e, sfac=sf), stats

    reset_collection = TMMC.reset_collection
    lnpi = TMMC.lnpi
    u_moments = TMMC.u_moments
