"""Gate of the LJ tail corrections in muVT exchange acceptance, on the
compiled f32 path.

The exact identity being tested (tests/test_lrc_exchange.py proves it
on CPU for the jnp path): U_lrc is configuration-independent at fixed
N, so the tail-corrected muVT distribution is an EXACT reweighting of
the uncorrected one,

    P_lrc(N)  =  P_off(N) exp(-beta g N^2) / Z,     U_lrc = g N^2.

Protocol (monatomic LJ with sigma near r_cut so the tail is large):
  1. jnp path, use_lrc=False  -> N-histogram  -> reweighted prediction;
  2. jnp path, use_lrc=True   -> <N>, Var(N) must match the prediction.
Gate: the LRC-on run inside a 4-sigma band of the exact prediction,
and the tail shift itself resolved (several sigma from the off mean).

Run: python docs/validation/run_gcmc_lrc.py.
Writes docs/validation/gcmc_lrc.txt.
"""

import dataclasses
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

from metropolismontecarlo_tpu.mc.gcmc import GCMC, make_slot_lj, n_counts
from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.system import RunParams

BOX, CAP, Z, T = 12.0, 64, 0.004, 1.5
CHAINS = int(os.environ.get("LRC_CHAINS", 1024))
BLOCKS = int(os.environ.get("LRC_BLOCKS", 8))
STEPS = int(os.environ.get("LRC_STEPS", 1500))


def params(use_lrc):
    return RunParams(strict_min_image=False, temperature=T, r_cut=2.5,
                     cutoff_mode="site", coulomb="none", lj_shift="none",
                     use_lrc=use_lrc, p_translate=0.4, dr_max=1.0)


def run(use_lrc, seed):
    """Returns (hist, q98_drift, max_drift).  History note: the FIRST
    run of this artifact showed O(1)-O(10) drift on an accelerator
    (CPU identical-trajectory replays were clean) — bisected to an XLA
    backend miscompilation that DROPPED the bool activity scatter of an
    accepted insertion while applying its com write and energy delta
    (fixed repo-wide by the one-hot where-select updates in
    utils/activity.py).  Both the drift quantile and its max are
    gated."""
    sysm = dataclasses.replace(
        lj_system(1), eps_table=np.full((1, 1), 0.5),
        sig_table=np.full((1, 1), 2.2))
    g = GCMC(sysm, params(use_lrc), activity=Z, capacity=CAP,
             dtype=jnp.float32)
    st = g.init(jax.random.PRNGKey(seed), box=BOX, n_init=8,
                n_chains=CHAINS)
    st, _ = g.run_block(st, 2500)                       # equil
    hist = np.zeros(CAP + 1)
    q98 = 0.0
    wmax = 0.0
    for _ in range(BLOCKS):
        # run_steps (NOT run_block: run_block resyncs state.energy to
        # the recompute before returning, which would compare the
        # recompute to itself) — then the per-chain carried-vs-dense
        # residual, then resync for the next block
        st = g.run_steps(st, STEPS)
        e = np.asarray(g.full_energy(st), np.float64)
        carried = np.asarray(st.energy, np.float64)
        scale = np.maximum(np.abs(e), 1.0)
        rel = np.abs(e - carried) / scale
        q98 = max(q98, float(np.quantile(rel, 0.98)))
        wmax = max(wmax, float(rel.max()))
        st = st._replace(energy=jnp.asarray(e, jnp.float32))
        hist += n_counts(st, CAP)
    return hist, q98, wmax


def moments(hist):
    n = np.arange(len(hist))
    w = hist / hist.sum()
    m = float((n * w).sum())
    v = float((n * n * w).sum() - m * m)
    return m, v


def main():
    dev = jax.devices()[0]
    t0 = time.time()
    sysm = dataclasses.replace(
        lj_system(1), eps_table=np.full((1, 1), 0.5),
        sig_table=np.full((1, 1), 2.2))
    g_val = float(make_slot_lj(sysm, params(True), CAP,
                               jnp.float64)[3](jnp.asarray(BOX)))

    h_off, q_off, w_off = run(False, 0)
    h_jnp, q_jnp, w_jnp = run(True, 1)

    n = np.arange(CAP + 1)
    logw = -(1.0 / T) * g_val * n.astype(np.float64) ** 2
    logw -= logw[h_off > 0].max()
    wts = np.where(h_off > 0, h_off * np.exp(logw), 0.0)
    mean_pred = float((n * wts).sum() / wts.sum())
    var_pred = float((n * n * wts).sum() / wts.sum() - mean_pred**2)

    m_off, v_off = moments(h_off)
    m_jnp, v_jnp = moments(h_jnp)
    # ~CHAINS correlated samples per block x BLOCKS; effective ~2000
    se = float(np.sqrt(var_pred / 2000.0))
    tol = 4.0 * se + 0.05
    shift = mean_pred - m_off

    ok = (shift > 0.8
          and abs(m_jnp - mean_pred) < tol
          and abs(v_jnp - var_pred) < 0.35 * var_pred + 0.5
          and q_off < 1e-4 and q_jnp < 1e-4
          and w_off < 1e-4 and w_jnp < 1e-4)
    lines = [
        "LJ tail corrections in muVT exchange acceptance: exact-"
        "reweight gate",
        f"device: {dev.device_kind}, {CHAINS} chains, cap {CAP}, "
        f"box {BOX}, z {Z}, T {T}; soft-sphere sigma 2.2 / r_cut 2.5, "
        f"g(box) = {g_val:.5f}",
        f"LRC-off <N> = {m_off:.3f} (var {v_off:.2f}); exact reweight "
        f"prediction for LRC-on: <N> = {mean_pred:.3f} "
        f"(var {var_pred:.2f}), tail shift = +{shift:.3f}",
        f"jnp LRC-on    <N> = {m_jnp:.3f} (var {v_jnp:.2f})  "
        f"[tol {tol:.3f}]  "
        f"[{'PASS' if abs(m_jnp - mean_pred) < tol else 'FAIL'}]",
        f"drift q98 (GATED < 1e-4): off {q_off:.1e}, "
        f"jnp-on {q_jnp:.1e}; max (same gate): "
        f"off {w_off:.1e}, jnp-on {w_jnp:.1e}",
        "(this drift gate caught an XLA backend's dropped-bool-scatter "
        "miscompile before the fix — utils/activity.py)",
        f"wall: {time.time() - t0:.0f} s",
        f"RESULT: {'PASS' if ok else 'FAIL'}",
    ]
    out = "\n".join(lines) + "\n"
    print(out)
    if os.environ.get("LRC_SMOKE"):
        return
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gcmc_lrc.txt")
    with open(path, "w") as f:
        f.write(out)
    assert ok, out


if __name__ == "__main__":
    main()
