"""Free-energy perturbation: deletion energies + Bennett acceptance ratio.

Widom insertion (mc/widom.py) estimates mu_ex from one direction only:
ghost insertions into the N-molecule ensemble.  At liquid density the
estimator is dominated by rare low-energy insertions and converges
slowly.  The Bennett acceptance ratio (Bennett, J. Comput. Phys. 22,
245 (1976); Frenkel & Smit ch. 7.2) combines those FORWARD samples with
REVERSE samples — the energies of deleting real molecules from the
(N+1)-molecule ensemble — into the provably minimum-variance two-state
estimator.  The reference has no free-energy machinery at all; this
module extends the beyond-parity Widom capability into a proper FEP
family.

Ensembles and works (all configurational; ideal terms cancel into the
uniform-ghost normalization exactly as in Widom):

  A = N-system x one ideal ghost uniform in V      Z_A = V * Z_N
  B = (N+1)-system                                  Z_B = Z_{N+1}
  beta * mu_ex = -ln(Z_B / Z_A)

  forward work  w_F = beta * dU_insert   (Widom ghosts, sampled in A)
  reverse work  w_R = -beta * dU_delete  (real molecules, sampled in B;
                                          by particle symmetry EVERY
                                          molecule of the species is a
                                          valid reverse sample)

`make_deletion_fn` evaluates dU_delete = U(N+1) - U(N without molecule
m) EXACTLY per the sampled model — the same per-style terms as the
Widom ghosts (LJ + LRC decrement, real/recip/self/intra Ewald with the
carried structure factors, Wolf constants, optional surface dipole) —
so insertion and deletion are reciprocal number-for-number (gated by
tests/test_fep.py).

Single-stage BAR still fails when the two endpoint ensembles barely
overlap — inserting a whole water into liquid water biases the
estimate by several kJ/mol no matter how many samples are thrown at
it.  The production answer is STAGED decoupling: `tag_last_molecule`
builds (N+1)-molecule systems whose last molecule carries
lambda-scaled LJ/charge interactions, each stage is sampled with the
ordinary driver (the stages are real Systems, so NPT, neighbour lists and
checkpoints all apply), `make_deletion_fn` on a stage's system yields
U_lambda - U_rest for the cross-stage works, and
`make_decoupled_insertion_fn` supplies Widom-style ghost samples of
the fully decoupled first rung.  beta*mu_ex = sum over adjacent-stage
BAR legs (docs/validation/run_bar_water.py).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from metropolismontecarlo_tpu.mc.widom import make_pose_eval
from metropolismontecarlo_tpu.models.system import System
from metropolismontecarlo_tpu.ops import ewald as ewald_ops
from metropolismontecarlo_tpu.ops import tail as tail_ops
from metropolismontecarlo_tpu.utils.chunking import chunked_vmap
from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR


def make_deletion_fn(system, params, kvecs, kweights, dtype=jnp.float32,
                     species=0, chunk=8, state_system=None):
    """Build deletion_du(state) -> (du (C, n_sp), overlap (C, n_sp)):
    the exact energy attributable to each molecule of the species,
    dU_m = U(state) - U(state minus molecule m), for every molecule and
    chain.  overlap mirrors the pair evaluator's hard-core flag (always
    False on configurations the chain itself sampled).

    chunk: chains per scan step (each chunk row holds an
    (n_sp, P, A_pad) pair grid).

    state_system: the System the STATE was sampled with, when it
    differs from `system` (staged-FEP cross-lambda works, U_lambda' -
    U_rest on lambda-rung samples).  The state's carried structure
    factors contain the molecule at the STATE system's charge scaling,
    so the reciprocal delta must strip that contribution before adding
    this system's — evaluating E(S_rest + s_eval) - E(S_rest) with
    S_rest = sfac - s_state.  Everything else (pair terms, LRC, self/
    intra, surface) is already built from `system`'s own tables.
    Gated by tests/test_fep.py::test_cross_lambda_deletion_consistency.
    """
    ev = make_pose_eval(system, params, kvecs, kweights, dtype, species)
    _, m0, m1, P, _ = system.species_slices[species]
    n_sp = m1 - m0
    M = system.n_mol
    mol_a0 = jnp.asarray(system.mol_a0)
    use_coul = params.coulomb != "none"
    factor = jnp.asarray(COULOMB_FACTOR, dtype)
    kv = None if kvecs is None else jnp.asarray(kvecs)
    kw = None if kweights is None else jnp.asarray(kweights, dtype)
    q_state_t = None
    if state_system is not None:
        q_state_t = jnp.asarray(
            np.asarray(state_system.charges)[m0, :P], dtype)

    # LRC decrement U_lrc(N) - U_lrc(N-1): static type-count vectors
    tm = np.asarray(system.type_ids)[m0, :P]
    counts_np = np.asarray(system.type_counts, np.float64)
    counts_minus_np = counts_np.copy()
    for t in tm:
        counts_minus_np[t] -= 1.0
    counts = jnp.asarray(counts_np, dtype)
    counts_minus = jnp.asarray(counts_minus_np, dtype)
    eps_tab = jnp.asarray(system.eps_table, dtype)
    sig_tab = jnp.asarray(system.sig_table, dtype)
    use_lrc = params.use_lrc and params.lj_shift == "none"

    def lrc_dec(box):
        if not use_lrc:
            return jnp.zeros((), dtype)
        vol = box**3
        return (tail_ops.lrc_energy(counts, eps_tab, sig_tab,
                                    params.r_cut, vol)
                - tail_ops.lrc_energy(counts_minus, eps_tab, sig_tab,
                                      params.r_cut, vol))

    def du_one(m, coords_t, com, box, sfac):
        """Deletion energy of molecule m (global index) in one chain."""
        ra = jax.lax.dynamic_slice_in_dim(coords_t, mol_a0[m], P,
                                          axis=1).T              # (P, 3)
        com_t = com[m]
        du, overlap = ev.pair_energy(com_t, ra, coords_t, com, box,
                                     ev.real, m)
        du = du + lrc_dec(box)
        if use_coul:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            if params.coulomb == "ewald":
                cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
                s_m = ev.pose_sfac(ra, box)
                if q_state_t is None:
                    # E(S) - E(S - s_m) = -[E(S + (-s_m)) - E(S)]
                    du = du - ewald_ops.recip_energy_delta(sfac, -s_m, cf)
                else:
                    # cross-lambda: the state's sfac carries THIS pose
                    # at the state system's charges — strip it, then
                    # add this system's: E(S_rest + s_m) - E(S_rest)
                    s_state = ewald_ops.structure_factor(ra, q_state_t,
                                                         kv, box)
                    du = du + ewald_ops.recip_energy_delta(
                        sfac - s_state, s_m, cf)
                du = du + ev.self_intra(box)
                if params.ewald_surface:
                    com_all = com[jnp.clip(ev.mol_of_atom, 0, M - 1)]
                    m_tot = ewald_ops.surface_dipole(
                        coords_t.T, com_all, ev.charges_flat, box)
                    mu_m = ewald_ops.surface_dipole(
                        ra, com_t[None, :], ev.q_t, box)
                    c_surf = factor * 2.0 * jnp.pi / (3.0 * box**3)
                    m_old = m_tot - mu_m
                    du = du + c_surf * (jnp.sum(m_tot * m_tot)
                                        - jnp.sum(m_old * m_old))
            elif params.coulomb == "wolf":
                du = du + ev.self_intra(box)
                # reference-convention constant: Q^2 - (Q - q_t)^2
                dq2 = ev.q_sys_tot**2 - (ev.q_sys_tot - ev.q_t_tot) ** 2
                du = du + ev.wolf_const_coeff(box) * dq2
        return du, overlap

    mols = jnp.arange(m0, m1, dtype=jnp.int32)

    def deletion_du(state):
        def chain(coords, com, box, sfac):
            f = lambda m: du_one(m, coords, com, box, sfac)  # noqa: E731
            return jax.vmap(f)(mols)

        return chunked_vmap(chain, chunk,
                            state.coords.astype(dtype),
                            state.com.astype(dtype),
                            state.box.astype(dtype),
                            state.sfac.astype(dtype))

    return deletion_du


@functools.lru_cache(maxsize=None)
def tag_last_molecule(system, lj_scale=1.0, q_scale=1.0):
    """A copy of `system` whose LAST molecule is an independent
    single-molecule species block ("<name>_tag") with scaled
    interactions — the staged-decoupling building block:

      U_lambda = U_rest + lj_scale * U_LJ(tag, rest)
                        + q_scale  * U_qq_linear + q_scale^2 * U_qq_self

    Charges scale by q_scale directly.  LJ scaling goes through NEW
    atom types (ids offset by T) whose mixed-table entries carry
    lj_scale on tag-rest rows and lj_scale^2 on tag-tag, with sigmas
    unchanged, so pair energies AND tail corrections scale exactly.

    At lj_scale == 0.0 the tagged sigmas are set to the pad value 1.0:
    a fully decoupled molecule may legally sit on top of another atom
    (distance floored at 1e-4 A^2), where an unscaled sigma overflows
    s12 to +inf in f32 and 0*inf would poison the zero-epsilon product
    with NaN — the same contract pad slots rely on (models/system.py).

    Sampling the returned system with the ordinary driver gives the
    lambda-stage ensemble; `make_deletion_fn(..., species=-1)` gives
    U_lambda - U_rest on its samples (the BAR work ingredient), and the
    lambda = (0, 0) system's total energy is EXACTLY the rest-system
    energy (gated by tests/test_fep.py).
    """
    m_last = system.n_mol - 1
    t = int(system.eps_table.shape[0])
    charges = np.array(system.charges, np.float64)
    charges[m_last] = q_scale * charges[m_last]
    type_ids = np.array(system.type_ids, np.int32)
    type_ids[m_last] = t + type_ids[m_last]

    eps = np.asarray(system.eps_table, np.float64)
    sig = np.asarray(system.sig_table, np.float64)
    eps_new = np.zeros((2 * t, 2 * t))
    eps_new[:t, :t] = eps
    eps_new[t:, :t] = lj_scale * eps
    eps_new[:t, t:] = lj_scale * eps
    eps_new[t:, t:] = (lj_scale**2) * eps
    sig_new = np.tile(sig, (2, 2))
    if lj_scale == 0.0:
        sig_new[t:, :] = 1.0
        sig_new[:, t:] = 1.0

    blocks = system.species
    if blocks is None:
        blocks = ((system.name, system.n_mol, system.atoms_per_mol),)
    name, count, p = blocks[-1]
    assert count >= 1
    head = blocks[:-1] + (((name, count - 1, p),) if count > 1 else ())
    species = head + ((name + "_tag", 1, p),)

    return dataclasses.replace(
        system, charges=charges, type_ids=type_ids, eps_table=eps_new,
        sig_table=sig_new, species=species,
        name=f"{system.name}_tag[{lj_scale:g},{q_scale:g}]")


def make_decoupled_insertion_fn(sys_tag, params, kvecs, kweights,
                                dtype=jnp.float32, chunk=8):
    """Ghost insertions of `sys_tag`'s TAGGED molecule (its last species
    block, from `tag_last_molecule`) into states sampled from the FULLY
    DECOUPLED stage (lj_scale = q_scale = 0), where the state's own
    tagged molecule is inert: its pose is uniform and independent, so
    arbitrary ghost poses are extra exact samples of that ensemble —
    the Widom trick applied to the first rung of a lambda ladder.

    Returns fn(state, com_t (C, n, 3), quat_t (C, n, 4)) ->
    (du (C, n), overlap (C, n)) with du = U_lambda(x with tag at pose)
    - U_0(x): the tagged pair terms under sys_tag's scaled parameters
    (state's inert tagged molecule excluded), the LRC increment, and
    for ewald the +recip delta against the state's structure factors
    (which carry NO tagged contribution at lambda = 0) plus self/intra;
    for wolf the self and total-charge-constant increments.

    The surface-dipole term is not supported here (the evaluator's
    charge table would misattribute the state's inert tagged molecule).
    """
    assert not params.ewald_surface, \
        "staged decoupling is defined under tinfoil boundaries"
    species = len(sys_tag.species_slices) - 1
    ev = make_pose_eval(sys_tag, params, kvecs, kweights, dtype, species)
    _, m0, m1, P, _ = sys_tag.species_slices[species]
    assert m1 - m0 == 1, "tagged block must hold exactly one molecule"
    m_tag = m0
    use_coul = params.coulomb != "none"
    kv = None if kvecs is None else jnp.asarray(kvecs)
    kw = None if kweights is None else jnp.asarray(kweights, dtype)

    # LRC increment U_lrc(rest + tag) - U_lrc(rest), with sys_tag's
    # lambda-scaled mixed tables (deletion-style counts: the tagged
    # types are already in sys_tag.type_counts)
    tm = np.asarray(sys_tag.type_ids)[m_tag, :P]
    counts_np = np.asarray(sys_tag.type_counts, np.float64)
    counts_minus_np = counts_np.copy()
    for ti in tm:
        counts_minus_np[ti] -= 1.0
    counts = jnp.asarray(counts_np, dtype)
    counts_minus = jnp.asarray(counts_minus_np, dtype)
    eps_tab = jnp.asarray(sys_tag.eps_table, dtype)
    sig_tab = jnp.asarray(sys_tag.sig_table, dtype)
    use_lrc = params.use_lrc and params.lj_shift == "none"
    q_env_tot = ev.q_sys_tot - ev.q_t_tot

    def lrc_inc(box):
        if not use_lrc:
            return jnp.zeros((), dtype)
        vol = box**3
        return (tail_ops.lrc_energy(counts, eps_tab, sig_tab,
                                    params.r_cut, vol)
                - tail_ops.lrc_energy(counts_minus, eps_tab, sig_tab,
                                      params.r_cut, vol))

    def du_one(com_t, quat_t, coords_t, com, box, sfac):
        ra = ev.pose_atoms(com_t, quat_t)
        du, overlap = ev.pair_energy(com_t, ra, coords_t, com, box,
                                     ev.real, m_tag)
        du = du + lrc_inc(box)
        if use_coul:
            kappa = jnp.asarray(params.kappa_L, dtype) / box
            if params.coulomb == "ewald":
                cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box, dtype)
                s_t = ev.pose_sfac(ra, box)
                du = du + ewald_ops.recip_energy_delta(sfac, s_t, cf)
                du = du + ev.self_intra(box)
            elif params.coulomb == "wolf":
                du = du + ev.self_intra(box)
                dq2 = (q_env_tot + ev.q_t_tot) ** 2 - q_env_tot**2
                du = du + ev.wolf_const_coeff(box) * dq2
        return du, overlap

    def ghost_du(state, com_t, quat_t):
        def chain(coords, com, box, sfac, ct, qt):
            f = lambda c1, q1: du_one(c1, q1, coords, com, box, sfac)  # noqa: E731
            return jax.vmap(f)(ct, qt)

        return chunked_vmap(chain, chunk,
                            state.coords.astype(dtype),
                            state.com.astype(dtype),
                            state.box.astype(dtype),
                            state.sfac.astype(dtype),
                            com_t.astype(dtype), quat_t.astype(dtype))

    return ghost_du


def lambda_basis(d_ljhalf, d_lj, d_half, d_full):
    """Per-sample (A, A2, B, C) basis of the tagged-molecule
    interaction.

    `tag_last_molecule` scales make every cross-lambda work an EXACT
    low-order polynomial in (lj, q):

        d(lj, q) = U_(lj,q) - U_rest = lj*A + lj^2*A2 + q*B + q^2*C

    A: tag-rest LJ pairs + the tag-rest tail rows (the eps table's
    tag-rest entries carry lj directly, not an LB sqrt, and LJ is
    linear in eps).  A2: the tag-TAG tail-correction self term (the
    doubled table's tag-tag block scales as lj^2) — small (~3 K for an
    SPC/E tag at V ~ 1.7e3 A^3) but measurably there; a 3-term basis
    without it reconstructs works ~0.6 K wrong.  B: real-space coulomb
    cross terms and the linear recip cross 2 q Re(S_rest . s_tag*).
    C: recip |s_tag|^2 plus the self and intra constants.  There is no
    lj*q cross term (LJ and coulomb never multiply).

    Four ladder works per sample recover the basis:
    d_ljhalf = d(1/2, 0), d_lj = d(1, 0), d_half = d(1, 1/2),
    d_full = d(1, 1) — and then the FULL (K, N) MBAR matrix over any
    lambda ladder is closed-form (gated to fp precision by
    tests/test_fep.py::test_lambda_basis_decomposition_exact).

    Returns (A, A2, B, C) arrays of the inputs' shape.
    """
    e1 = np.asarray(d_lj, np.float64)            # A + A2
    e2 = np.asarray(d_ljhalf, np.float64)        # A/2 + A2/4
    a = 4.0 * e2 - e1
    a2 = e1 - a
    d2 = np.asarray(d_half, np.float64) - e1     # B/2 + C/4
    d3 = np.asarray(d_full, np.float64) - e1     # B + C
    b = 4.0 * d2 - d3
    c = d3 - b
    return a, a2, b, c


def lambda_work(lj, q, a, a2, b, c):
    """d(lj, q) from a `lambda_basis` decomposition."""
    return lj * a + (lj * lj) * a2 + q * b + (q * q) * c


def _expit(z):
    """Numerically stable logistic 1/(1+exp(-z)) (host NumPy)."""
    return 0.5 * (1.0 + np.tanh(0.5 * z))


def bar_solve(w_f, w_r, tol=1e-12, max_iter=200):
    """Solve Bennett's self-consistent equation for the reduced free-
    energy difference x = beta*(F_B - F_A) given reduced works
    w_f = beta*(U_B - U_A) on A-samples and w_r = beta*(U_A - U_B) on
    B-samples:

        sum_i expit(x - M - w_f_i) = sum_j expit(-x - M' ... )

    i.e. the standard form  sum_F 1/(1+exp(M + w_F - x)) =
    sum_R 1/(1+exp(-M + w_R + x)),  M = ln(n_F/n_R).

    The left side is increasing and the right decreasing in x, so the
    root is unique; solved by bisection (robust to +inf works from
    overlap-vetoed insertions, which contribute zero).
    """
    # works beyond +-1e6 reduced units are indistinguishable from +-inf
    # through the logistic (contribute exactly 0/1 weight) but would
    # inflate the bisection bracket by orders of magnitude — clip.
    w_f = np.clip(np.asarray(w_f, np.float64).ravel(), -1e6, 1e6)
    w_r = np.clip(np.asarray(w_r, np.float64).ravel(), -1e6, 1e6)
    n_f, n_r = w_f.size, w_r.size
    assert n_f > 0 and n_r > 0
    m = np.log(n_f / n_r)

    def g(x):
        lhs = _expit(x - m - w_f)          # 1/(1+exp(M + w_F - x))
        rhs = _expit(m - w_r - x)          # 1/(1+exp(-M + w_R + x))
        return np.sum(lhs) - np.sum(rhs)

    # bracket the root: g is increasing in x
    finite = w_f[np.isfinite(w_f)]
    lo = min(np.min(finite, initial=0.0), np.min(-w_r, initial=0.0)) - 50.0
    hi = max(np.max(finite, initial=0.0), np.max(-w_r, initial=0.0)) + 50.0
    assert g(lo) < 0.0 < g(hi), "BAR root not bracketed (no overlap?)"
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        if g(mid) < 0.0:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


def bar_mu_ex(du_insert, overlap_insert, du_delete, temperature):
    """Excess chemical potential from BAR (energy units of the run).

    du_insert (any shape): Widom ghost insertion energies sampled in the
    N-molecule ensemble (mc/widom.make_widom_fn's widom_du), with
    overlap_insert marking hard-core-vetoed ghosts (infinite work).
    du_delete: per-molecule deletion energies sampled in the
    (N+1)-molecule ensemble (make_deletion_fn).  temperature: kT in the
    same units (per-chain ladders must reweight before pooling).
    """
    beta = 1.0 / float(temperature)
    w_f = np.where(np.asarray(overlap_insert, bool),
                   np.inf, beta * np.asarray(du_insert, np.float64))
    w_r = -beta * np.asarray(du_delete, np.float64)
    return float(temperature) * bar_solve(w_f, w_r)
