"""FEP/BAR (mc/fep.py): the BAR solver against closed forms, exact
insertion/deletion reciprocity across coulomb styles, and the
statistical BAR == Widom mu_ex gate on a dense LJ fluid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.mc.fep import (
    bar_mu_ex,
    bar_solve,
    lambda_basis,
    lambda_work,
    make_decoupled_insertion_fn,
    make_deletion_fn,
    tag_last_molecule,
)
from metropolismontecarlo_tpu.mc.widom import make_widom_fn, mu_excess
from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system
from metropolismontecarlo_tpu.ops.quaternions import (
    random_quaternion,
    rotate_vectors,
)

F64 = jnp.float64


def test_bar_solver_identical_states():
    """A == B (all works zero): the free-energy difference is zero even
    with asymmetric sample counts."""
    assert bar_solve(np.zeros(100), np.zeros(37)) == pytest.approx(0.0,
                                                                   abs=1e-9)


def test_bar_solver_gaussian_closed_form():
    """Gaussian work distributions: Crooks fixes the reverse-work
    distribution to N(sigma^2 - m, sigma^2) given forward N(m, sigma^2),
    and the exact answer is dF = m - sigma^2/2."""
    rng = np.random.default_rng(0)
    m, sig = 3.0, 1.5
    w_f = rng.normal(m, sig, 200_000)
    w_r = rng.normal(sig**2 - m, sig, 200_000)
    df = bar_solve(w_f, w_r)
    assert df == pytest.approx(m - sig**2 / 2.0, abs=0.02)


def test_bar_solver_vetoed_insertions():
    """+inf forward works (hard-core vetoes) contribute zero weight but
    still count as attempts: the answer shifts by ln of the effective
    sample fraction relative to dropping them."""
    w_f = np.concatenate([np.zeros(50), np.full(50, np.inf)])
    w_r = np.zeros(100)
    # exact: sum expit(x) over 50 = sum expit(-x) over 100
    #   -> e^x/(1+e^x)*50 = 100/(1+e^x) -> e^x = 2
    assert bar_solve(w_f, w_r) == pytest.approx(np.log(2.0), abs=1e-9)


STYLES = [
    dict(coulomb="ewald"),
    dict(coulomb="ewald", ewald_surface=True),
    dict(coulomb="wolf", wolf_style="ref"),
    dict(coulomb="bare", use_lrc=False),
]


@pytest.mark.parametrize("kw", STYLES, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
def test_insertion_deletion_reciprocity_water(kw):
    """Inserting a ghost water at pose X into the 8-molecule state must
    cost EXACTLY what deleting that molecule from the 9-molecule state
    returns — every per-style term (LJ, LRC, real/recip/self/intra,
    wolf constants, surface dipole) has to match."""
    box, m = 12.0, 8
    params = RunParams(strict_min_image=False, temperature=300.0,
                       r_cut=5.0, cutoff_mode="site", **kw)
    sys8, sys9 = spce_system(m), spce_system(m + 1)
    com8 = jnp.asarray(cubic_lattice(m, box), F64)
    quat8 = random_quaternion(jax.random.PRNGKey(11), (m,), F64)
    com_t = jnp.asarray([3.3, 7.1, 9.2], F64)
    quat_t = random_quaternion(jax.random.PRNGKey(101), (), F64)

    mc8 = MonteCarlo(sys8, params, dtype=F64,
                     recompute_chunk=1)
    body = jnp.asarray(np.asarray(sys8.body), F64)
    coords8 = (com8[:, None, :] + rotate_vectors(quat8, body)).reshape(-1, 3)
    state8 = mc8.init_from_coords(jax.random.PRNGKey(0), coords8, com8,
                                  box=box, n_chains=1)
    widom_du, _ = make_widom_fn(sys8, params, mc8.kvecs, mc8.kweights,
                                dtype=F64, chunk=1)
    du_ins, ovr = widom_du(state8, com_t[None, None, :],
                           quat_t[None, None, :])
    assert not bool(np.asarray(ovr)[0, 0])

    # the 9-molecule state at the SAME pose (state8's rebuilt coords)
    body_t = jnp.asarray(np.asarray(sys9.body)[m], F64)
    ra_t = com_t[None, :] + rotate_vectors(quat_t, body_t)
    coords9 = jnp.concatenate(
        [state8.coords[0, :, : sys8.n_atoms].T, ra_t], axis=0)
    com9 = jnp.concatenate([com8, com_t[None, :]], axis=0)
    mc9 = MonteCarlo(sys9, params, dtype=F64,
                     recompute_chunk=1)
    state9 = mc9.init_from_coords(jax.random.PRNGKey(0), coords9, com9,
                                  box=box, n_chains=1)
    deletion_du = make_deletion_fn(sys9, params, mc9.kvecs, mc9.kweights,
                                   dtype=F64, chunk=1)
    du_del, ovr_del = deletion_du(state9)
    assert du_del.shape == (1, m + 1)
    assert not bool(np.asarray(ovr_del)[0, m])
    assert float(du_del[0, m]) == pytest.approx(float(du_ins[0, 0]),
                                                rel=1e-8)


def test_insertion_deletion_reciprocity_lj():
    """Monatomic P=1 path with tail corrections: the LRC increment of
    insertion equals the LRC decrement of deletion."""
    n, box = 32, 6.0
    params = RunParams(strict_min_image=False, temperature=1.0,
                       r_cut=2.5, coulomb="none", use_lrc=True)
    com_n = jnp.asarray(cubic_lattice(n, box), F64)
    com_t = jnp.asarray([0.71, 2.9, 4.13], F64)
    mc_n = MonteCarlo(lj_system(n), params, dtype=F64,
                      recompute_chunk=1)
    s_n = mc_n.init_state(jax.random.PRNGKey(0), com_n, box=box, n_chains=1)
    widom_du, _ = make_widom_fn(lj_system(n), params, None, None,
                                dtype=F64, chunk=1)
    quat_t = jnp.zeros((1, 1, 4), F64).at[..., 0].set(1.0)
    du_ins, _ = widom_du(s_n, com_t[None, None, :], quat_t)

    com_n1 = jnp.concatenate([com_n, com_t[None, :]], axis=0)
    mc_n1 = MonteCarlo(lj_system(n + 1), params, dtype=F64,
                       recompute_chunk=1)
    s_n1 = mc_n1.init_from_coords(jax.random.PRNGKey(0), com_n1, com_n1,
                                  box=box, n_chains=1)
    deletion_du = make_deletion_fn(lj_system(n + 1), params, None, None,
                                   dtype=F64, chunk=1)
    du_del, _ = deletion_du(s_n1)
    assert float(du_del[0, n]) == pytest.approx(float(du_ins[0, 0]),
                                                rel=1e-10)


def test_bar_matches_widom_dense_lj():
    """Dense LJ fluid (rho* = 0.5, T* = 1.2): mu_ex from BAR (insertions
    into N=64 + deletions from N=65) must agree with the direct Widom
    estimate within combined statistical error."""
    n, t = 64, 1.2
    box = float((n / 0.5) ** (1.0 / 3.0))
    params = RunParams(temperature=t, r_cut=2.4, coulomb="none",
                       use_lrc=True, p_translate=1.0, dr_max=0.35)
    C, n_ins, blocks, steps = 8, 256, 4, 100
    key = jax.random.PRNGKey(42)

    mc_n = MonteCarlo(lj_system(n), params, dtype=F64, recompute_chunk=4)
    st_n = mc_n.init_state(key, cubic_lattice(n, box), box=box, n_chains=C)
    st_n, _ = mc_n.run_block(st_n, 300, adjust=True)
    widom_du, _ = make_widom_fn(lj_system(n), params, None, None,
                                dtype=F64, chunk=4)

    mc_n1 = MonteCarlo(lj_system(n + 1), params, dtype=F64,
                       recompute_chunk=4)
    st_n1 = mc_n1.init_state(key, cubic_lattice(n + 1, box), box=box,
                             n_chains=C)
    st_n1, _ = mc_n1.run_block(st_n1, 300, adjust=True)
    deletion_du = make_deletion_fn(lj_system(n + 1), params, None, None,
                                   dtype=F64, chunk=4)

    du_f, ov_f, du_r, boltz = [], [], [], []
    for b in range(blocks):
        st_n, stats = mc_n.run_block(st_n, steps, adjust=False)
        assert stats["drift_max_rel"] < 1e-10
        k_pos = jax.random.fold_in(jax.random.PRNGKey(7), b)
        u = jax.random.uniform(k_pos, (C, n_ins, 3), F64) \
            * st_n.box[:, None, None]
        qt = jnp.zeros((C, n_ins, 4), F64).at[..., 0].set(1.0)
        du, ov = widom_du(st_n, u, qt)
        du_f.append(np.asarray(du))
        ov_f.append(np.asarray(ov))
        boltz.append(np.where(np.asarray(ov), 0.0,
                              np.exp(-np.asarray(du) / t)))

        st_n1, stats1 = mc_n1.run_block(st_n1, steps, adjust=False)
        assert stats1["drift_max_rel"] < 1e-10
        du_r.append(np.asarray(deletion_du(st_n1)[0]))

    mu_widom = float(mu_excess(jnp.asarray(np.mean(boltz)), t))
    mu_bar = bar_mu_ex(np.concatenate([a.ravel() for a in du_f]),
                       np.concatenate([a.ravel() for a in ov_f]),
                       np.concatenate([a.ravel() for a in du_r]), t)
    # per-block Widom spread as the error scale
    per_block = [-t * np.log(max(np.mean(b), 1e-300)) for b in boltz]
    sem = np.std(per_block) / np.sqrt(len(per_block))
    assert mu_bar == pytest.approx(mu_widom, abs=max(6.0 * sem, 0.15)), \
        (mu_bar, mu_widom, sem)
    assert mu_bar < 0.0  # attractive-dominated at this state point


# ---------------- staged decoupling (lambda ladders) ----------------


def _water9_states(kw, lj_scale, q_scale):
    """(params, sys_tag, state at lambda, state at lambda=0, pose of the
    tagged molecule): 8 lattice waters + 1 tagged water at a fixed pose,
    identical coordinates in both states."""
    box, m = 12.0, 8
    params = RunParams(strict_min_image=False, temperature=300.0,
                       r_cut=5.0, cutoff_mode="site", **kw)
    sys_tag = tag_last_molecule(spce_system(m + 1), lj_scale, q_scale)
    sys_0 = tag_last_molecule(spce_system(m + 1), 0.0, 0.0)
    com8 = jnp.asarray(cubic_lattice(m, box), F64)
    quat8 = random_quaternion(jax.random.PRNGKey(11), (m,), F64)
    com_t = jnp.asarray([3.3, 7.1, 9.2], F64)
    quat_t = random_quaternion(jax.random.PRNGKey(101), (), F64)
    com9 = jnp.concatenate([com8, com_t[None, :]], axis=0)
    quat9 = jnp.concatenate([quat8, quat_t[None, :]], axis=0)

    mc_l = MonteCarlo(sys_tag, params, dtype=F64,
                      recompute_chunk=1)
    state_l = mc_l.init_state(jax.random.PRNGKey(0), com9, quat=quat9,
                              box=box, n_chains=1)
    mc_0 = MonteCarlo(sys_0, params, dtype=F64,
                      recompute_chunk=1)
    # park the lambda=0 state's inert tagged molecule SOMEWHERE ELSE:
    # ghost insertions must exclude it, so its pose cannot matter
    com9_far = com9.at[m].set(jnp.asarray([1.0, 1.0, 1.0], F64))
    state_0 = mc_0.init_state(jax.random.PRNGKey(0), com9_far, quat=quat9,
                              box=box, n_chains=1)
    return params, sys_tag, mc_l, state_l, mc_0, state_0, com_t, quat_t


def test_tagged_full_coupling_is_identity():
    """lambda = (1, 1) tagging must not change the physics: total energy
    equals the untagged system's on identical coordinates."""
    box, m = 12.0, 9
    params = RunParams(strict_min_image=False, temperature=300.0,
                       r_cut=5.0, cutoff_mode="site", coulomb="ewald")
    com = jnp.asarray(cubic_lattice(m, box), F64)
    quat = random_quaternion(jax.random.PRNGKey(3), (m,), F64)
    base = spce_system(m)
    tagged = tag_last_molecule(base, 1.0, 1.0)
    e = []
    for system in (base, tagged):
        mc = MonteCarlo(system, params, dtype=F64,
                        recompute_chunk=1)
        st = mc.init_state(jax.random.PRNGKey(0), com, quat=quat,
                           box=box, n_chains=1)
        e.append(float(st.energy[0]))
    assert e[1] == pytest.approx(e[0], rel=1e-12)


def test_tagged_decoupled_is_rest_system():
    """lambda = (0, 0): the tagged molecule is inert — total energy
    equals the (N-1)-molecule system's even with the tagged molecule
    INSIDE another one (the pad-sigma contract keeps f32-style 0*inf
    out of the sum)."""
    box, m = 12.0, 8
    params = RunParams(strict_min_image=False, temperature=300.0,
                       r_cut=5.0, cutoff_mode="site", coulomb="ewald")
    com8 = jnp.asarray(cubic_lattice(m, box), F64)
    quat8 = random_quaternion(jax.random.PRNGKey(5), (m,), F64)
    mc8 = MonteCarlo(spce_system(m), params, dtype=F64,
                     recompute_chunk=1)
    st8 = mc8.init_state(jax.random.PRNGKey(0), com8, quat=quat8,
                         box=box, n_chains=1)

    sys_0 = tag_last_molecule(spce_system(m + 1), 0.0, 0.0)
    # tagged COM exactly on molecule 0's COM: the worst case
    com9 = jnp.concatenate([com8, com8[:1]], axis=0)
    quat9 = jnp.concatenate(
        [quat8, random_quaternion(jax.random.PRNGKey(7), (1,), F64)], axis=0)
    mc0 = MonteCarlo(sys_0, params, dtype=F64,
                     recompute_chunk=1)
    st0 = mc0.init_state(jax.random.PRNGKey(0), com9, quat=quat9,
                         box=box, n_chains=1)
    assert np.isfinite(float(st0.energy[0]))
    assert float(st0.energy[0]) == pytest.approx(float(st8.energy[0]),
                                                 rel=1e-12)


@pytest.mark.parametrize("kw", STYLES[:3], ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
def test_ghost_insertion_matches_stage_deletion(kw):
    """The leg-0 works: inserting the lambda-scaled ghost into the
    decoupled state must cost exactly what make_deletion_fn reports on
    the coupled state at the same pose, U_lambda(x) - U_rest(x)."""
    if kw.get("ewald_surface"):
        pytest.skip("staged decoupling is tinfoil-only")
    lj_s, q_s = 0.37, 0.61
    (params, sys_tag, mc_l, state_l, mc_0, state_0, com_t,
     quat_t) = _water9_states(kw, lj_s, q_s)
    deletion_du = make_deletion_fn(sys_tag, params, mc_l.kvecs,
                                   mc_l.kweights, dtype=F64, chunk=1,
                                   species=-1)
    du_del, _ = deletion_du(state_l)
    ghost_du = make_decoupled_insertion_fn(sys_tag, params, mc_0.kvecs,
                                           mc_0.kweights, dtype=F64,
                                           chunk=1)
    du_ins, ovr = ghost_du(state_0, com_t[None, None, :],
                           quat_t[None, None, :])
    assert not bool(np.asarray(ovr)[0, 0])
    assert float(du_ins[0, 0]) == pytest.approx(float(du_del[0, 0]),
                                                rel=1e-9)


def test_stage_deletion_telescopes_to_energy():
    """U_lambda(x) - U_0(x) from make_deletion_fn must equal the
    difference of the two drivers' independently initialized total
    energies (every term accounted once)."""
    (params, sys_tag, mc_l, state_l, mc_0, state_0, _,
     _) = _water9_states(dict(coulomb="ewald"), 0.37, 0.61)
    # recompute the lambda = 0 energy at the SAME coordinates
    state_0same = mc_0.init_state(
        jax.random.PRNGKey(0),
        state_l.com[0], quat=state_l.quat[0],
        box=float(state_l.box[0]), n_chains=1)
    deletion_du = make_deletion_fn(sys_tag, params, mc_l.kvecs,
                                   mc_l.kweights, dtype=F64, chunk=1,
                                   species=-1)
    du_del, _ = deletion_du(state_l)
    de = float(state_l.energy[0]) - float(state_0same.energy[0])
    assert float(du_del[0, 0]) == pytest.approx(de, rel=1e-10)


def test_staged_bar_equals_widom_lj():
    """Dense LJ: mu_ex summed over a 3-leg lambda ladder (ghosts ->
    0.25 -> 0.6 -> 1.0, epsilon scaling) must agree with direct Widom
    insertion into the rest system."""
    n, t = 32, 1.2
    box = float(((n + 1) / 0.5) ** (1.0 / 3.0))
    params = RunParams(temperature=t, r_cut=2.4, coulomb="none",
                       use_lrc=True, p_translate=1.0, dr_max=0.35,
                       strict_min_image=False)
    C, n_ins, blocks, steps = 8, 192, 5, 60
    lams = [0.0, 0.25, 0.6, 1.0]
    systems = [tag_last_molecule(lj_system(n + 1), l, 0.0) for l in lams]
    mcs = [MonteCarlo(s, params, dtype=F64, recompute_chunk=4)
           for s in systems]
    dels = [None] + [make_deletion_fn(s, params, None, None, dtype=F64,
                                      chunk=4, species=-1)
                     for s in systems[1:]]
    ghost_du = make_decoupled_insertion_fn(systems[1], params, None, None,
                                           dtype=F64, chunk=4)

    # direct Widom on the rest system
    mc_w = MonteCarlo(lj_system(n), params, dtype=F64, recompute_chunk=4)
    st_w = mc_w.init_state(jax.random.PRNGKey(1), cubic_lattice(n, box),
                           box=box, n_chains=C)
    st_w, _ = mc_w.run_block(st_w, 200, adjust=True)
    widom_du, _ = make_widom_fn(lj_system(n), params, None, None,
                                dtype=F64, chunk=4)
    boltz = []
    for b in range(blocks):
        st_w, _ = mc_w.run_block(st_w, steps, adjust=False)
        u = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(9), b),
                               (C, n_ins, 3), F64) * st_w.box[:, None, None]
        qt = jnp.zeros((C, n_ins, 4), F64).at[..., 0].set(1.0)
        du, ov = widom_du(st_w, u, qt)
        boltz.append(np.where(np.asarray(ov), 0.0,
                              np.exp(-np.asarray(du) / t)))
    mu_widom = -t * np.log(np.mean(boltz))
    per_block = [-t * np.log(np.mean(b)) for b in boltz]
    sem = np.std(per_block) / np.sqrt(len(per_block))

    # ladder: warm-start each stage from the previous one's samples
    st = mcs[0].init_state(jax.random.PRNGKey(2),
                           cubic_lattice(n + 1, box), box=box, n_chains=C)
    st, _ = mcs[0].run_block(st, 200, adjust=True)
    d_here = [[] for _ in lams]      # works at the stage's own lambda
    d_next = [[] for _ in lams]      # works at the next lambda
    d_prev = [[] for _ in lams]      # works at the previous lambda
    ins_f, ins_o = [], []
    for i in range(len(lams)):
        if i > 0:
            st = mcs[i].resync(st)
            st, _ = mcs[i].run_block(st, 100, adjust=True)
        for b in range(blocks):
            st, stats = mcs[i].run_block(st, steps, adjust=False)
            assert stats["drift_max_rel"] < 1e-9
            if i == 0:
                u = jax.random.uniform(
                    jax.random.fold_in(jax.random.PRNGKey(13), b),
                    (C, n_ins, 3), F64) * st.box[:, None, None]
                qt = jnp.zeros((C, n_ins, 4), F64).at[..., 0].set(1.0)
                du, ov = ghost_du(st, u, qt)
                ins_f.append(np.asarray(du).ravel())
                ins_o.append(np.asarray(ov).ravel())
            else:
                d_here[i].append(np.asarray(dels[i](st)[0]).ravel())
                if i + 1 < len(lams):
                    d_next[i].append(np.asarray(dels[i + 1](st)[0]).ravel())
                d_prev[i].append(np.asarray(dels[i - 1](st)[0]).ravel()
                                 if i - 1 > 0 else
                                 np.zeros_like(d_here[i][-1]))

    x_tot = 0.0
    for leg in range(len(lams) - 1):
        if leg == 0:
            w_f = np.where(np.concatenate(ins_o), np.inf,
                           np.concatenate(ins_f) / t)
        else:
            w_f = (np.concatenate(d_next[leg])
                   - np.concatenate(d_here[leg])) / t
        w_r = (np.concatenate(d_prev[leg + 1])
               - np.concatenate(d_here[leg + 1])) / t
        x_tot += bar_solve(w_f, w_r)
    mu_staged = t * x_tot
    assert mu_staged == pytest.approx(mu_widom, abs=max(6.0 * sem, 0.2)), \
        (mu_staged, mu_widom, sem)


def test_lambda_basis_decomposition_exact():
    """d(lj, q) = lj*A + lj^2*A2 + q*B + q^2*C exactly: the basis
    recovered from works at (1/2,0), (1,0), (1,1/2), (1,1) must
    reproduce the work at ARBITRARY (lj, q) — including the state's own
    rung — to fp precision.  This is what makes full-matrix lambda
    MBAR free: four evaluations give every rung.  (The lj^2 term is the
    tag-tag tail-correction self entry: a 3-term basis without it was
    measurably ~0.6 K wrong on this 9-water state.)"""
    (params, sys_a, mc_a, state_a, _mc0, _st0, _c,
     _q) = _water9_states(dict(coulomb="ewald"), 0.7, 0.4)

    def work_at(lj, q):
        s = tag_last_molecule(spce_system(9), lj, q)
        mc = MonteCarlo(s, params, dtype=F64,
                        recompute_chunk=1)
        return float(make_deletion_fn(
            s, params, mc.kvecs, mc.kweights, dtype=F64, chunk=1,
            species=-1, state_system=sys_a)(state_a)[0][0, 0])

    basis = lambda_basis(work_at(0.5, 0.0), work_at(1.0, 0.0),
                         work_at(1.0, 0.5), work_at(1.0, 1.0))
    for lj, q in ((0.7, 0.4), (0.3, 0.9), (0.05, 0.0), (1.0, 0.75)):
        direct = work_at(lj, q)
        recon = float(lambda_work(lj, q, *basis))
        assert recon == pytest.approx(direct, rel=1e-9, abs=1e-6), \
            (lj, q, direct, recon)


def test_cross_lambda_deletion_consistency():
    """Cross-rung works: U_b(x) - U_a(x) assembled from
    make_deletion_fn(sys_b, state_system=sys_a) minus the same-system
    deletion, on a state initialized at lambda_a, must equal the
    difference of the two drivers' independent total energies — in
    particular when the CHARGE scaling differs, where the state's
    carried structure factors hold the tagged molecule at lambda_a and
    the naive E(S) - E(S - s_b) delta is wrong by the second-law-
    violating 2*q_b*(q_a - q_b)|s_u|^2 cross term."""
    (params, sys_a, mc_a, state_a, _mc0, _st0, _c,
     _q) = _water9_states(dict(coulomb="ewald"), 0.7, 0.4)
    sys_b = tag_last_molecule(spce_system(9), 1.0, 0.9)
    mc_b = MonteCarlo(sys_b, params, dtype=F64,
                      recompute_chunk=1)
    state_b = mc_b.init_state(jax.random.PRNGKey(0), state_a.com[0],
                              quat=state_a.quat[0],
                              box=float(state_a.box[0]), n_chains=1)
    d_a = make_deletion_fn(sys_a, params, mc_a.kvecs, mc_a.kweights,
                           dtype=F64, chunk=1, species=-1)(state_a)[0]
    d_b = make_deletion_fn(sys_b, params, mc_b.kvecs, mc_b.kweights,
                           dtype=F64, chunk=1, species=-1,
                           state_system=sys_a)(state_a)[0]
    de = float(state_b.energy[0]) - float(state_a.energy[0])
    assert float(d_b[0, 0] - d_a[0, 0]) == pytest.approx(de, rel=1e-10)


def test_tag_last_molecule_ragged_mixture():
    """Solvation free energies in MIXTURES: tagging the last molecule of
    a ragged TIP4P/2005-in-SPC/E system (4-site solute after 3-site
    waters) must reproduce the full system at lambda = (1,1) and the
    pure-water rest system at lambda = (0,0), and the cross-lambda
    deletion works must telescope to the independent energy difference."""
    from metropolismontecarlo_tpu.models.mixture import mixture_system
    from metropolismontecarlo_tpu.models.water import tip4p2005_system

    n_sol = 12
    full = mixture_system([(spce_system(1), n_sol),
                           (tip4p2005_system(1), 1)])
    rest = mixture_system([(spce_system(1), n_sol)])
    box = 14.0
    params = RunParams(strict_min_image=False, temperature=300.0,
                       r_cut=6.0, cutoff_mode="site", coulomb="ewald",
                       nk=4, ksq_max=16)
    com = jnp.asarray(cubic_lattice(n_sol + 1, box), F64)
    quat = random_quaternion(jax.random.PRNGKey(21), (n_sol + 1,), F64)

    def energy(system, n_keep):
        mc = MonteCarlo(system, params, dtype=F64,
                        recompute_chunk=1)
        st = mc.init_state(jax.random.PRNGKey(0), com[:n_keep],
                           quat=quat[:n_keep], box=box, n_chains=1)
        return mc, st

    _, st_full = energy(full, n_sol + 1)
    _, st_rest = energy(rest, n_sol)
    mc_1, st_1 = energy(tag_last_molecule(full, 1.0, 1.0), n_sol + 1)
    mc_h, st_h = energy(tag_last_molecule(full, 0.45, 0.8), n_sol + 1)
    _, st_0 = energy(tag_last_molecule(full, 0.0, 0.0), n_sol + 1)

    e = lambda st: float(st.energy[0])  # noqa: E731
    assert e(st_1) == pytest.approx(e(st_full), rel=1e-12)
    assert e(st_0) == pytest.approx(e(st_rest), rel=1e-12)

    # cross-lambda works on the 4-site tagged solute telescope exactly
    d_h = make_deletion_fn(mc_h.system, params, mc_h.kvecs, mc_h.kweights,
                           dtype=F64, chunk=1, species=-1)(st_h)[0]
    d_1x = make_deletion_fn(mc_1.system, params, mc_1.kvecs, mc_1.kweights,
                            dtype=F64, chunk=1, species=-1,
                            state_system=mc_h.system)(st_h)[0]
    assert float(d_h[0, 0]) == pytest.approx(e(st_h) - e(st_0), rel=1e-10)
    assert float(d_1x[0, 0] - d_h[0, 0]) == pytest.approx(
        e(st_1) - e(st_h), rel=1e-9)
