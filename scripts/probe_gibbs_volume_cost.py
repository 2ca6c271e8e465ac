"""Measure the Gibbs volume-move cost at production p_volume.

Gibbs volume exchanges are full-recompute moves.  This probe measures
their share of the run: the bench Gibbs config (cap-128 SPC/E x 2
boxes) timed over identical attempt counts with the production volume
cadence (p_volume = 0.01, the gibbs_water artifact setting) vs
p_volume = 0 — the difference is the volume-move share of the wall.

Run on a GPU: python scripts/probe_gibbs_volume_cost.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax
import jax.numpy as jnp

from metropolismontecarlo_tpu.mc.gibbs_mol import make_gibbs_mol
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system
from metropolismontecarlo_tpu.ops.ewald import tune_parameters
from metropolismontecarlo_tpu.utils.cache import enable_compile_cache

N_CHAINS = int(os.environ.get("PROBE_CHAINS", 512))
CYCLES = int(os.environ.get("PROBE_CYCLES", 8))


def build(p_volume, chunk=8):
    cap, px = 128, 0.3
    n_l, n_v = (2 * cap) // 3, cap // 6
    box_l = (n_l / 0.0267) ** (1.0 / 3.0)
    box_v = 18.0
    r_cut = min(7.5, 0.45 * box_l)
    box_max = (box_l**3 + box_v**3) ** (1.0 / 3.0)
    kl, nk, ksq = tune_parameters(box_max, r_cut, 1e-3)
    params = RunParams(temperature=450.0, r_cut=r_cut,
                       cutoff_mode="site", coulomb="ewald", kappa_L=kl,
                       nk=nk, ksq_max=ksq, p_translate=0.5, dr_max=0.3,
                       dphi_max=0.4, p_volume=p_volume, use_lrc=False,
                       strict_min_image=False)
    init, run_steps = make_gibbs_mol(
        spce_system(cap), params, dv_max=0.03, p_transfer=px,
        dtype=jnp.float32, chunk=chunk)[:2]
    st = init(jax.random.PRNGKey(0), boxes=(box_l, box_v),
              n_init=(n_l, n_v), n_chains=N_CHAINS)
    x_per = max(1, int(round(2 * cap * px / (1.0 - px))))
    att_pc = 2 * cap + x_per
    return run_steps, st, att_pc


def time_one(p_volume, chunk=8):
    run_steps, st, att_pc = build(p_volume, chunk)
    n_steps = CYCLES * att_pc
    t0 = time.time()
    st = run_steps(st, n_steps)
    jax.block_until_ready(st.energy)
    compile_s = time.time() - t0
    # timed: 2 repetitions of the same static n_steps
    t0 = time.time()
    for _ in range(2):
        st = run_steps(st, n_steps)
    jax.block_until_ready(st.energy)
    dt = (time.time() - t0) / 2
    return dt, compile_s, att_pc


def main():
    enable_compile_cache()
    print(f"device: {jax.devices()[0].device_kind}, {N_CHAINS} chains, "
          f"{CYCLES} cycles/call")
    dt_off, c_off, att = time_one(0.0)
    print(f"p_volume = 0    : {dt_off:.3f} s/call (compile {c_off:.0f} s)")
    for chunk in (8, 32, 128):
        dt_on, c_on, _ = time_one(0.01, chunk)
        n_vol = max(1, int(round(0.01 * att * CYCLES)))
        share = (dt_on - dt_off) / dt_on
        print(f"p_volume = 0.01 chunk {chunk:3d}: {dt_on:.3f} s/call "
              f"(compile {c_on:.0f} s, ~{n_vol} volume attempts/call), "
              f"volume share {share * 100:.1f}%, "
              f"{(dt_on - dt_off) * 1e3 / n_vol:.1f} ms/attempt")


if __name__ == "__main__":
    main()
