"""SPC/E hydration free energy: staged decoupling vs the
single-stage estimators.

The excess chemical potential of SPC/E water at 298.15 K / 0.997 g/cc
is a classic free-energy benchmark (literature ~ -24.2 kJ/mol, e.g.
Hummer et al. J. Phys. Chem. 100, 1206 (1996)).  It is also the
classic demonstration of why free-energy METHODS matter more than
sample counts:

  * direct Widom insertion is carried by ~1-in-1e4 cavity hits: the
    estimator is dominated by the far tail of the insertion-energy
    distribution and scatters by several kJ/mol run to run (measured
    here: -19.97 at 21M ghosts in one run, -29.55 at 1.6M in another);
  * single-stage BAR (insertions + deletions) is minimum-variance but
    still assumes the two work distributions overlap — in dense water
    they barely do, and it sits several kJ/mol off with a deceptively
    tiny fold spread (measured: -29.3 at 21M samples from
    short-equilibrated endpoints, -26.0 from well-equilibrated ones);
  * the production answer is STAGED decoupling: a ladder of
    lambda-scaled tagged systems (mc/fep.tag_last_molecule), each
    rung sampled with the ordinary driver, adjacent rungs
    bridged by BAR on exact cross-lambda works (make_deletion_fn),
    with Widom-style ghosts on the fully decoupled rung
    (make_decoupled_insertion_fn).

All estimators come out of ONE run: each sample (ghost pose or rung
state) is evaluated at the FOUR lambda-basis systems (mc/fep.
lambda_basis: d(lj,q) = lj*A + lj^2*A2 + q*B + q^2*C exactly), which
yields its work at EVERY rung in closed form — so the same collection
pass feeds Widom (full-coupling ghosts), single-stage BAR, staged
adjacent-rung BAR, and the pooled full-ladder MBAR solve.

Run: `python docs/validation/run_bar_water.py`.
Writes docs/validation/bar_water.txt.
Smoke: `BAR_SMOKE=1 BAR_N=16 BAR_CHAINS=4 ...` (CPU, minutes).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import jax

if os.environ.get("BAR_CPU"):       # smoke runs on the CPU
    jax.config.update("jax_platforms", "cpu")
# 12 rungs x (sweep + ghost/deletion evaluators) = dozens of compiles;
# cache them so reruns pay sampling only
from metropolismontecarlo_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.mc.fep import (
    bar_solve,
    lambda_basis,
    lambda_work,
    make_decoupled_insertion_fn,
    make_deletion_fn,
    tag_last_molecule,
)
from metropolismontecarlo_tpu.mc.mbar import mbar_solve
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system
from metropolismontecarlo_tpu.ops.quaternions import (
    random_quaternion,
    rotate_vectors,
)

KJMOL_PER_K = 1.0 / 120.272236695
N = int(os.environ.get("BAR_N", 216))   # rest-system waters
T = 298.15
RHO = 0.997        # g/cc (sets the box from N)
N_CHAINS = int(os.environ.get("BAR_CHAINS", 1024))
EQUIL_BLOCKS = int(os.environ.get("BAR_EQUIL", 10))    # stage-0, x250 sweeps
STAGE_EQUIL = int(os.environ.get("BAR_STAGE_EQUIL", 4))   # per rung, x50
PROD_BLOCKS = int(os.environ.get("BAR_PROD", 12))      # per rung, x50
BLOCK = 50
N_INS = 128        # ghost insertions per chain per decoupled-rung block
LIT_KJMOL = -24.2

# lambda ladder: grow LJ first (geometric at the soft end, where the
# effective core radius ~ lambda^(1/12)), then charge at full LJ
# (electrostatic legs are smooth; spacing ~ linear response lambda^2)
LJ_LADDER = [0.005, 0.025, 0.08, 0.2, 0.4, 0.7, 1.0]
Q_LADDER = [0.25, 0.5, 0.75, 1.0]
if os.environ.get("BAR_SMOKE"):
    LJ_LADDER = [0.02, 0.2, 1.0]
    Q_LADDER = [0.5, 1.0]
LAMBDAS = ([(0.0, 0.0)] + [(l, 0.0) for l in LJ_LADDER]
           + [(1.0, q) for q in Q_LADDER])


def box_edge(n):
    m_w = 18.01528          # g/mol
    na = 6.02214076e23
    vol_cc = n * m_w / (na * RHO)
    return (vol_cc * 1e24) ** (1.0 / 3.0)   # Angstrom


def main():
    dev = jax.devices()[0]
    t0 = time.time()
    box = box_edge(N)
    r_cut = min(9.0, 0.45 * box)
    n_stage = len(LAMBDAS)
    print(f"box {box:.3f} A, r_cut {r_cut:.2f}, {N_CHAINS} chains, "
          f"{n_stage} rungs, device {dev.device_kind}", flush=True)

    params = RunParams(temperature=T, r_cut=r_cut, cutoff_mode="site",
                       coulomb="ewald", use_lrc=True, p_translate=0.5,
                       dr_max=0.3, dphi_max=0.3,
                       strict_min_image=N >= 100)
    systems = [tag_last_molecule(spce_system(N + 1), lj, q)
               for lj, q in LAMBDAS]
    mcs = [MonteCarlo(s, params, dtype=jnp.float32) for s in systems]
    # the lambda-work BASIS (mc/fep.lambda_basis): every cross-lambda
    # work is exactly lj*A + lj^2*A2 + q*B + q^2*C, so evaluating each
    # sample at FOUR systems — (1/2,0), (1,0), (1,1/2), (1,1) — yields
    # its work at EVERY rung in closed form: the same collection cost
    # as the old adjacent-triple scheme buys the full MBAR matrix
    i_lj = LAMBDAS.index((1.0, 0.0))
    i_qh = next(i for i, (l, q) in enumerate(LAMBDAS)
                if l == 1.0 and abs(q - 0.5) < 1e-12)
    i_qf = LAMBDAS.index((1.0, 1.0))
    systems.append(tag_last_molecule(spce_system(N + 1), 0.5, 0.0))
    mcs.append(MonteCarlo(systems[-1], params, dtype=jnp.float32))
    i_ljh = len(systems) - 1               # evaluation-only system
    basis_cols = (i_ljh, i_lj, i_qh, i_qf)

    _dels = {}

    def del_fn(j, i):
        """U_{lambda_j} - U_rest evaluator for states sampled at
        lambda_i (cross-lambda carried-sfac stripping when i != j)."""
        if (j, i) not in _dels:
            _dels[(j, i)] = make_deletion_fn(
                systems[j], params, mcs[j].kvecs, mcs[j].kweights,
                dtype=jnp.float32, chunk=8, species=-1,
                state_system=None if i == j else systems[i])
        return _dels[(j, i)]
    ghosts_basis = [make_decoupled_insertion_fn(
        systems[j], params, mcs[0].kvecs, mcs[0].kweights,
        dtype=jnp.float32, chunk=8) for j in basis_cols]

    m_tag = N
    a0 = int(systems[0].mol_a0[m_tag])
    body_t = jnp.asarray(np.asarray(systems[0].body)[m_tag, :3], jnp.float32)

    # ---- stage 0: decoupled rung (environment = N interacting waters)
    st = mcs[0].init_state(jax.random.PRNGKey(1),
                           cubic_lattice(N + 1, box), box=box,
                           n_chains=N_CHAINS)
    worst = 0.0
    for _ in range(EQUIL_BLOCKS):
        st, stats = mcs[0].run_block(st, 250, adjust=True)
    print(f"rung 0 equilibrated: <E>/N = "
          f"{stats['energy_mean'] / N:.1f} K  dr "
          f"{stats['dr_max_mean']:.2f}  [{time.time() - t0:.0f} s]",
          flush=True)

    g_basis, ov0 = [[] for _ in basis_cols], []
    best_com = best_quat = None
    for b in range(PROD_BLOCKS):
        st, stats = mcs[0].run_block(st, BLOCK, adjust=False)
        worst = max(worst, stats["drift_max_rel"])
        k = jax.random.fold_in(jax.random.PRNGKey(77), b)
        kp, kq = jax.random.split(k)
        u = jax.random.uniform(kp, (N_CHAINS, N_INS, 3), jnp.float32) \
            * st.box[:, None, None]
        qt = random_quaternion(kq, (N_CHAINS, N_INS), jnp.float32)
        dus = []
        o1 = None
        for acc, gfn in zip(g_basis, ghosts_basis):
            du, o = gfn(st, u, qt)
            acc.append(np.asarray(du, np.float64))
            dus.append(du)
            o1 = o                       # identical masks (same poses)
        ov0.append(np.asarray(o1, bool))
        if b == PROD_BLOCKS - 1:
            # teleport targets for rung 1: each chain's lowest-energy
            # ghost pose at lambda_1 (any start is legal; equilibration
            # re-thermalizes — this one is guaranteed core-free).
            # lambda_1's work is reconstructed from the basis.
            ba = lambda_basis(*[np.asarray(d, np.float64) for d in dus])
            du1 = jnp.asarray(lambda_work(*LAMBDAS[1], *ba))
            pick = jnp.argmin(jnp.where(o1, jnp.inf, du1), axis=1)
            best_com = jnp.take_along_axis(u, pick[:, None, None], 1)[:, 0]
            best_quat = jnp.take_along_axis(qt, pick[:, None, None], 1)[:, 0]

    # ---- rungs 1..K: sample each lambda, collect the 4-work basis
    d_at = [dict() for _ in range(n_stage)]   # d_at[i][j]: works of
    #   rung i's samples evaluated with rung j's parameters, (C, S)
    bases = [None] * n_stage                  # (A, A2, B, C) per rung
    for i in range(1, n_stage):
        if i == 1:
            ra = best_com[:, None, :] + rotate_vectors(best_quat, body_t)
            st = st._replace(
                com=st.com.at[:, m_tag].set(best_com),
                quat=st.quat.at[:, m_tag].set(best_quat),
                coords=st.coords.at[:, :, a0:a0 + 3]
                .set(jnp.swapaxes(ra, 1, 2)))
        st = mcs[i].resync(st)
        for _ in range(STAGE_EQUIL):
            st, stats = mcs[i].run_block(st, BLOCK, adjust=True)
        cols = {j: [] for j in basis_cols}
        for b in range(PROD_BLOCKS):
            st, stats = mcs[i].run_block(st, BLOCK, adjust=False)
            worst = max(worst, stats["drift_max_rel"])
            assert stats["drift_max_rel"] < 1e-4, (i, b, stats)
            for j, acc in cols.items():
                acc.append(np.asarray(del_fn(j, i)(st)[0], np.float64))
        ba = lambda_basis(*[np.concatenate(cols[j], axis=1)
                            for j in basis_cols])
        bases[i] = ba
        # the basis gives this rung's samples' works at EVERY rung
        d_at[i] = {j: lambda_work(*LAMBDAS[j], *ba)
                   for j in range(n_stage)}
        lj, q = LAMBDAS[i]
        print(f"rung {i:2d} (lj {lj:g}, q {q:g}): "
              f"<d_self> = {d_at[i][i].mean() * KJMOL_PER_K:+8.2f} kJ/mol  "
              f"drift {stats['drift_max_rel']:.1e}  "
              f"[{time.time() - t0:.0f} s]", flush=True)

    # ---- assemble works per leg, solve BAR per chain-fold
    gb = lambda_basis(*[np.concatenate(acc, axis=1) for acc in g_basis])
    ov0 = np.concatenate(ov0, axis=1)           # (C, S0)
    wf0 = lambda_work(*LAMBDAS[1], *gb)         # ghost works at rung 1
    wfull = lambda_work(1.0, 1.0, *gb)          # ... at full coupling
    ovfull = ov0
    beta = 1.0 / T

    def leg_works(leg, chains):
        """(w_f, w_r) of leg (stage leg -> leg+1) restricted to a
        chain subset."""
        if leg == 0:
            w_f = np.where(ov0[chains], np.inf, beta * wf0[chains])
            w_r = -beta * d_at[1][1][chains]
        else:
            w_f = beta * (d_at[leg][leg + 1] - d_at[leg][leg])[chains]
            w_r = beta * (d_at[leg + 1][leg] - d_at[leg + 1][leg + 1])[chains]
        return w_f.ravel(), w_r.ravel()

    all_chains = np.arange(N_CHAINS)
    legs = []
    for leg in range(n_stage - 1):
        w_f, w_r = leg_works(leg, all_chains)
        x = bar_solve(w_f, w_r)
        legs.append(x)
        print(f"leg {leg:2d} {LAMBDAS[leg]} -> {LAMBDAS[leg + 1]}: "
              f"dF = {x * T * KJMOL_PER_K:+8.3f} kJ/mol   "
              f"w_f {np.mean(w_f[np.isfinite(w_f)]):+7.2f} "
              f"+- {np.std(w_f[np.isfinite(w_f)]):6.2f}  "
              f"w_r {np.mean(w_r):+7.2f} +- {np.std(w_r):6.2f} kT",
              flush=True)
    mu_staged = T * sum(legs)

    folds = []
    for f in np.array_split(all_chains, 4):
        folds.append(T * sum(bar_solve(*leg_works(g, f))
                             for g in range(n_stage - 1)))
    sem = np.std(folds) / np.sqrt(len(folds))

    # ---- full-matrix MBAR over the whole ladder (same collected data)
    lam_pow = np.asarray([(l, l * l, q, q * q) for l, q in LAMBDAS])

    def mbar_mu(chains):
        """beta*(F_full - F_decoupled) by MBAR: rung-0 samples are the
        ghost (environment, pose) pairs, rungs 1.. the sampled states;
        every u_kn row is closed-form from the lambda basis."""
        stride = max(1, int(np.ceil(ov0[chains].size / 120_000)))
        b0 = np.stack([x[chains].ravel()[::stride] for x in gb])
        o0 = ov0[chains].ravel()[::stride]
        cols = [b0] + [np.stack([x[chains].ravel() for x in bases[i]])
                       for i in range(1, n_stage)]
        n_k = [c.shape[1] for c in cols]
        allb = np.concatenate(cols, axis=1)          # (4, N_tot)
        u_kn = beta * (lam_pow @ allb)               # (K, N_tot)
        # core-vetoed ghost poses are legal rung-0 samples (u_0 = 0)
        # with hard-zero weight everywhere else
        veto = np.zeros(allb.shape[1], bool)
        veto[:n_k[0]] = o0
        u_kn[1:, veto] = np.inf
        f = mbar_solve(u_kn, n_k, tol=1e-8, max_iter=50_000)
        return T * f[-1]

    mu_mbar = mbar_mu(all_chains)
    mbar_folds = [mbar_mu(f) for f in np.array_split(all_chains, 4)]
    sem_mbar = np.std(mbar_folds) / np.sqrt(len(mbar_folds))

    # single-run diagnostics: Widom-only and single-stage BAR
    boltz = np.where(ovfull, 0.0, np.exp(-np.minimum(beta * wfull, 500.0)))
    mu_widom = -T * np.log(boltz.mean())
    w_f_ss = np.where(ovfull, np.inf, beta * wfull).ravel()
    w_r_ss = (-beta * d_at[n_stage - 1][n_stage - 1]).ravel()
    mu_ss = T * bar_solve(w_f_ss, w_r_ss)

    to_kj = KJMOL_PER_K
    ok = (abs(mu_staged * to_kj - LIT_KJMOL) < max(2.5, 6.0 * sem * to_kj)
          and abs(mu_mbar * to_kj - LIT_KJMOL)
          < max(2.5, 6.0 * sem_mbar * to_kj)
          and abs((mu_mbar - mu_staged) * to_kj)
          < max(1.5, 6.0 * (sem + sem_mbar) * to_kj))
    lines = [
        "SPC/E hydration free energy via STAGED decoupling",
        f"device: {dev.device_kind}, f32 sampling, "
        f"{N_CHAINS} chains",
        f"state point: N = {N}(+tag) waters, box {box:.3f} A "
        f"({RHO} g/cc), {T} K, Ewald, r_cut {r_cut:.1f} A + LRC",
        f"ladder: {n_stage} rungs ({len(LJ_LADDER)} LJ + "
        f"{len(Q_LADDER)} charging), {PROD_BLOCKS}x{BLOCK} sweeps/rung, "
        f"{wf0.size / 1e6:.1f}M decoupled-rung ghosts "
        f"({(~ov0).mean() * 100:.1f}% core-free)",
        f"mu_ex (Widom-only)       = {mu_widom * to_kj:+.2f} kJ/mol "
        "(one-sided, tail-dominated)",
        f"mu_ex (single-stage BAR) = {mu_ss * to_kj:+.2f} kJ/mol "
        "(two-state, overlap-limited)",
        f"mu_ex (staged BAR)       = {mu_staged * to_kj:+.2f} "
        f"+- {sem * to_kj:.2f} kJ/mol (4 chain-folds)",
        f"mu_ex (full-ladder MBAR) = {mu_mbar * to_kj:+.2f} "
        f"+- {sem_mbar * to_kj:.2f} kJ/mol (pooled 12-state solve on "
        "the same samples via the lambda-work basis)",
        f"literature (SPC/E)       ~ {LIT_KJMOL} kJ/mol",
        f"worst block drift: {worst:.2e}",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    if os.environ.get("BAR_SMOKE"):
        return
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bar_water.txt")
    with open(path, "w") as f:
        f.write(out)
    assert ok, out


if __name__ == "__main__":
    main()
