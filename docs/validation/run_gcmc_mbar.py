"""MBAR activity pooling of an interacting-LJ GCMC activity-ladder run.

`mc/mbar.reweight_activity_mbar` pools muVT samples taken at several
activities: at fixed T, V the beta*U term is common to every activity
state and cancels out of MBAR identically, so only the molecule-number
time series is needed.  The ideal-gas closed form is gated in
tests/test_mbar.py; this artifact checks the cancellation argument on
real INTERACTING runs — and exercises the per-chain ACTIVITY LADDER
(`mc/gcmc.make_gcmc` with a (n_chains,) activity): at fixed volume the
rung P(N) distributions are narrow (sigma ~ sqrt(N)-ish), so bridging
between rungs needs densely spaced activities; a ladder samples all of
them in ONE compiled run (a first attempt with 3 rungs spaced x2 in z
left adjacent rungs with NO P(N) overlap — MBAR reported ESS ~ 58 of
6144 and a 4% biased mean, exactly the honesty diagnostic working).

Protocol: one 8-rung x 32-chain ladder run, MBAR-pool the pooled N
series, predict <N> at two never-sampled activities between rungs, and
gate against direct muVT runs at those activities.

Run: `python docs/validation/run_gcmc_mbar.py`.
Writes docs/validation/gcmc_mbar.txt.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import jax

from metropolismontecarlo_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.mc.gcmc import GCMC
from metropolismontecarlo_tpu.mc.mbar import reweight_activity_mbar
from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.system import RunParams

BOX, T = 7.0, 2.0
Z_RUNGS = np.geomspace(0.15, 0.50, 8)        # ratio ~1.19 per rung
PER_RUNG = 32
Z_TARGETS = [0.22, 0.40]
CAP = 256
BLOCKS, STEPS, EQUIL_BLOCKS = 8, 1500, 4


def _params():
    return RunParams(strict_min_image=False, temperature=T, r_cut=2.5,
                     cutoff_mode="site", coulomb="none", p_translate=0.5,
                     dr_max=0.4, use_lrc=False)


def run(activity, n_chains, seed):
    """One muVT run (scalar z or ladder); returns (C*BLOCKS,) N samples
    laid out block-major and the block-mean trace."""
    g = GCMC(lj_system(1), _params(), activity=activity, capacity=CAP,
             dtype=jnp.float32)
    st = g.init(jax.random.PRNGKey(seed), box=BOX, n_init=32,
                n_chains=n_chains)
    for _ in range(EQUIL_BLOCKS):
        st, _ = g.run_block(st, STEPS)
    samples, means = [], []
    for _ in range(BLOCKS):
        st, stats = g.run_block(st, STEPS, drift_tol=1e-4)
        assert stats["full_frac"] == 0.0, f"capacity saturated ({activity})"
        samples.append(np.asarray(jnp.sum(st.active, axis=1)))
        means.append(stats["n_mean"])
    return np.stack(samples), means          # (BLOCKS, C)


def main():
    dev = jax.devices()[0]
    t0 = time.time()
    ladder = np.repeat(Z_RUNGS, PER_RUNG)    # (256,)
    samp, _ = run(ladder, ladder.size, 11)   # (BLOCKS, 256)
    # regroup to (K, S): rung k owns chains [k*PER_RUNG, (k+1)*PER_RUNG)
    n_kn = (samp.reshape(BLOCKS, len(Z_RUNGS), PER_RUNG)
            .transpose(1, 0, 2).reshape(len(Z_RUNGS), -1))
    out = reweight_activity_mbar(n_kn, Z_RUNGS, Z_TARGETS)

    lines = [
        "MBAR activity pooling of a GCMC activity-ladder run "
        "(supercritical LJ)",
        f"device: {dev.device_kind}, backend: {jax.default_backend()}",
        f"protocol: box={BOX} T={T} r_cut=2.5 no-LRC, one ladder run of "
        f"{len(Z_RUNGS)} rungs x {PER_RUNG} chains "
        f"(z in [{Z_RUNGS[0]:.2f}, {Z_RUNGS[-1]:.2f}] geometric), "
        f"{BLOCKS} blocks x {STEPS} steps after {EQUIL_BLOCKS * STEPS} "
        f"equil, f32; pooled samples {n_kn.size}",
        f"rung <N>: {np.round(n_kn.mean(axis=1), 1).tolist()}",
    ]
    ok = True
    for j, z in enumerate(Z_TARGETS):
        _, d_means = run(z, 256, 50 + j)
        d_mean = float(np.mean(d_means))
        d_sem = float(np.std(d_means) / np.sqrt(len(d_means)))
        m, ess = out["n_mean"][j], out["ess"][j]
        err = abs(m - d_mean)
        tol = max(5.0 * d_sem, 0.01 * d_mean)
        ok &= err < tol and ess > 0.02 * n_kn.size
        lines.append(
            f"z={z}: MBAR <N> {m:.2f} (ess {ess:.0f} of {n_kn.size}) vs "
            f"direct {d_mean:.2f} +- {d_sem:.2f} [|d| {err:.2f} < {tol:.2f}]")
    lines += [
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    outtxt = "\n".join(lines) + "\n"
    print(outtxt)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gcmc_mbar.txt")
    with open(path, "w") as f:
        f.write(outtxt)
    print("wrote", path)


if __name__ == "__main__":
    main()
