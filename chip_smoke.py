"""Bring-up smoke run of the Metropolis MC main path on NVIDIA GPUs.

    python chip_smoke.py           one GPU: device, the flagship SPC/E
                                   750-water Ewald NVT run through the CLI,
                                   f32 energies vs the float64 NumPy
                                   reference, the LJ acceptance anchor, the
                                   open ensembles' jnp legs, and a trace
    python chip_smoke.py --four    four GPUs: chain-sharded REMC vs the
                                   unsharded run, and the 2x2 tensor-
                                   parallel recompute vs the replicated one

Each phase prints one JSON line.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
A failing phase raises, so the script exits non-zero without that line;
so does a machine where JAX finds no GPU.  One process drives every card.
Run outputs (CLI metrics, the trace) go under --out.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# f32 vs float64 reference: each component's |e32 - e64| must stay below
# REL_TOL times that component's own magnitude; the total (and the
# carried total) below REL_TOL times the sum of the component
# magnitudes, because the self and intramolecular terms (~8x the total
# each, opposite signs) cancel in it.  f32 accumulation over the ~2.5M
# pair terms leaves ~1e-7..1e-6 of each scale; a TF32 (10-bit mantissa)
# contraction in the Ewald phases would leave ~1e-3.
REL_TOL = 2e-5
# the LJ anchor: 256 atoms, rho 0.75, T 1.0, dr_max = box/30, no adjust
LJ_ACCEPTANCE, LJ_ACCEPTANCE_TOL = 0.47, 0.03


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}, default=float), flush=True)


def check(ok, what):
    """Fail the phase (a check that survives `python -O`)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def require_gpu():
    """The JAX devices, or SystemExit(2) when the first is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a CUDA GPU; JAX found "
              f"{devs[0].platform!r}", file=sys.stderr)
        raise SystemExit(2)
    return devs


def phase_device(devs):
    import jax
    import jaxlib

    from metropolismontecarlo_tpu.utils.cache import enable_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120, check=True)
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    emit("device", platform=devs[0].platform, kind=devs[0].device_kind,
         count=len(devs), jax=jax.__version__, jaxlib=jaxlib.__version__,
         xla_flags=os.environ.get("XLA_FLAGS", ""),
         compile_cache=enable_compile_cache(),
         nvidia_smi=smi.stdout.strip().splitlines())


def load_flagship(n_chains=None):
    """(cfg, system, params, MonteCarlo) of configs/spce_750.json."""
    import jax.numpy as jnp

    from metropolismontecarlo_tpu.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu.utils.config import (
        build_params,
        build_system,
        load_config,
    )

    cfg = load_config(os.path.join(REPO, "configs", "spce_750.json"))
    if n_chains is not None:
        cfg["run"]["n_chains"] = n_chains
    system = build_system(cfg, REPO)
    params = build_params(cfg)
    return cfg, system, params, MonteCarlo(system, params, dtype=jnp.float32)


def phase_flagship(out_dir, n_blocks=4, n_steps=10, n_chains=None):
    """configs/spce_750.json through `run.main`, cut to n_blocks blocks
    of n_steps sweeps (equil_blocks as shipped).  Returns the final
    state."""
    import numpy as np

    from metropolismontecarlo_tpu import run as cli

    cfg, _, _, _ = load_flagship(n_chains)
    cfg["run"].update(n_blocks=n_blocks, n_steps=n_steps)
    run_dir = os.path.join(out_dir, "spce_750")
    cfg["run"]["output"]["dir"] = run_dir
    os.makedirs(run_dir, exist_ok=True)
    cfg_path = os.path.join(run_dir, "config.json")
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(metrics_path):
        os.remove(metrics_path)         # the logger appends
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    t0 = time.perf_counter()
    state = cli.main([cfg_path, "--quiet"])
    wall = time.perf_counter() - t0
    with open(metrics_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    blocks = [r for r in rows if "drift_max_rel" in r]
    prod = [r for r in blocks if r.get("phase") == "prod"]
    drift = max(r["drift_max_rel"] for r in blocks)
    acc_t = float(np.mean([r["acc_trans"] for r in prod]))
    acc_r = float(np.mean([r["acc_rot"] for r in prod]))
    energies = [r[k] for r in blocks
                for k in ("energy_mean", "energy_min", "energy_max")]
    emit("flagship_cli", config="configs/spce_750.json",
         n_chains=cfg["run"]["n_chains"], n_blocks=n_blocks,
         n_steps=n_steps, wall_s=wall, drift_max_rel=drift,
         acc_trans=acc_t, acc_rot=acc_r,
         energy_mean_last=blocks[-1]["energy_mean"],
         dr_max_mean=blocks[-1]["dr_max_mean"],
         dphi_max_mean=blocks[-1]["dphi_max_mean"])
    check(len(blocks) == n_blocks and prod, rows)
    check(np.all(np.isfinite(energies)), energies)
    check(drift <= 1e-5, drift)
    check(0.2 <= acc_t <= 0.8 and 0.2 <= acc_r <= 0.8, (acc_t, acc_r))
    return state


def phase_energy_reference(mc, state, n_sweeps=2, chains=(0, 1)):
    """f32 carried energy (after n_sweeps more sweeps) and the f32 full
    recompute, component by component, against the float64 reference."""
    import jax
    import numpy as np

    from metropolismontecarlo_tpu.models.energy import energy_breakdown_jit
    from metropolismontecarlo_tpu.reference import energy_components

    system, params = mc.system, mc.params
    state = mc.run_steps(state, n_sweeps, False)
    jax.block_until_ready(state.energy)
    A = system.n_atoms
    rows = []
    for c in chains:
        coords = state.coords[c, :, :A].T
        out = energy_breakdown_jit(system, params, coords, state.com[c],
                                   state.box[c], mc.kvecs, mc.kweights)
        ref = energy_components(system, params,
                                np.asarray(coords, np.float64),
                                np.asarray(state.com[c], np.float64),
                                float(state.box[c]))
        scale = sum(abs(v) for k, v in ref.items() if k != "total")
        errs = {k: abs(float(out[k]) - v) / max(abs(v), 1.0)
                for k, v in ref.items() if k != "total"}
        errs["total"] = abs(float(out["total"]) - ref["total"]) / scale
        carried = float(state.energy[c])
        errs["carried_total"] = abs(carried - ref["total"]) / scale
        rows.append({"chain": c, "ref": ref, "f32": {
            k: float(out[k]) for k in ref}, "carried_total": carried,
            "rel_err": errs})
    worst = max(max(r["rel_err"].values()) for r in rows)
    emit("energy_vs_float64_reference", rel_tol=REL_TOL, worst=worst,
         chains=rows)
    check(worst <= REL_TOL, worst)
    return state


def phase_lj(n_chains=512, n_equil=100, n_measure=100):
    import jax
    import jax.numpy as jnp

    from metropolismontecarlo_tpu.io.configs import cubic_lattice
    from metropolismontecarlo_tpu.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu.models.monatomic import (
        lj_box_for_density,
        lj_system,
    )
    from metropolismontecarlo_tpu.models.system import RunParams

    n = 256
    box = lj_box_for_density(n, 0.75)
    params = RunParams(temperature=1.0, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=box / 30)
    mc = MonteCarlo(lj_system(n), params, dtype=jnp.float32)
    state = mc.init_state(jax.random.PRNGKey(0), cubic_lattice(n, box),
                          box=box, n_chains=n_chains)
    state = mc.run_steps(state, n_equil, False)
    state, m = mc.run_block(state, n_measure, adjust=False)
    emit("lj_anchor", n_chains=n_chains, acceptance=m["acc_trans"],
         expected=LJ_ACCEPTANCE, tol=LJ_ACCEPTANCE_TOL,
         energy_per_atom=m["energy_mean"] / n,
         drift_max_rel=m["drift_max_rel"])
    check(abs(m["acc_trans"] - LJ_ACCEPTANCE) <= LJ_ACCEPTANCE_TOL, m)


def phase_ensembles(n_chains=None, n_units=2, drift_tol=1e-4):
    """A few sweep-equivalents of each open ensemble's jnp leg at the
    bench's system sizes, with the block drift check."""
    import bench

    runs = {"gcmc_mol": lambda c: bench.setup_muvt("gcmc", c),
            "tmmc_mol": lambda c: bench.setup_muvt("tmmc", c),
            "gibbs_mol": bench.setup_gibbs,
            "semigrand": bench.setup_semigrand}
    c = n_chains or 1024
    for name, setup in runs.items():
        _, state, label, attempts, ens = setup(c)
        t0 = time.perf_counter()
        state, stats = ens.run_block(state, n_units * attempts,
                                     drift_tol=drift_tol)
        emit("ensemble", name=name, label=label, n_chains=c,
             attempts=n_units * attempts, wall_s=time.perf_counter() - t0,
             drift_max_rel=stats["drift_max_rel"], drift_tol=drift_tol,
             stats={k: v for k, v in stats.items()
                    if isinstance(v, (int, float))})
        check(stats["drift_max_rel"] < drift_tol, (name, stats))


def phase_trace(mc, state, out_dir, n_sweeps=2):
    """Time and trace n_sweeps flagship sweeps after warm-up."""
    import glob

    import jax

    from metropolismontecarlo_tpu.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu.utils import trace as tr

    system = mc.system
    C, M = state.com.shape[0], system.n_mol
    run = MonteCarlo.run_steps
    state = run(mc, state, n_sweeps, False)
    jax.block_until_ready(state.energy)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = run(mc, state, n_sweeps, False)
        jax.block_until_ready(state.energy)
        walls.append(time.perf_counter() - t0)
    tdir = os.path.join(out_dir, "trace")
    with jax.profiler.trace(tdir):
        t0 = time.perf_counter()
        state = run(mc, state, n_sweeps, False)
        jax.block_until_ready(state.energy)
        traced_wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(tdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    events, lines = tr.device_events(path)
    summary = tr.summarize(events, int(traced_wall * 1e9), n_sweeps * M)
    compiled = run.lower(mc, state, n_sweeps, False).compile()
    a_pad = system.n_atoms_padded
    n_copy, where = tr.full_copies_in_loops(
        compiled.as_text(), f"f32[{C},3,{a_pad}]")
    mem = compiled.memory_analysis()
    mem = {k: getattr(mem, k) for k in dir(mem)
           if k.endswith("_in_bytes")}
    dev_stats = jax.devices()[0].memory_stats() or {}
    pairs_per_move = C * 2 * 3 * a_pad
    emit("trace", n_chains=C, n_sweeps=n_sweeps,
         sweeps_per_s=[C * n_sweeps / w for w in walls],
         untraced_wall_s=walls, traced_wall_s=traced_wall,
         device_lines=lines, **summary,
         pairs_per_move=pairs_per_move,
         full_state_copies_in_loop=n_copy, copy_sites=where,
         memory_analysis=mem,
         peak_bytes_in_use=dev_stats.get("peak_bytes_in_use"))
    check(summary["n_events"] > 0, lines)
    return state


def phase_four(n_chains=512, n_rounds=2, sweeps_per_round=1, n_tp=16):
    """Chain-sharded REMC on a 4-device mesh vs the same chains unsharded
    on one device, and the 2x2 tensor-parallel recompute vs the
    replicated one."""
    import jax
    import numpy as np

    from metropolismontecarlo_tpu.parallel.mesh import (
        make_mesh,
        sharded_run_steps,
    )
    from metropolismontecarlo_tpu.parallel.remc import (
        exchange,
        temperature_ladder,
    )
    from metropolismontecarlo_tpu.parallel.tp import (
        make_mesh_2d,
        tp_full_energy_fn,
    )
    from metropolismontecarlo_tpu.run import _initial_state

    cfg, system, params, mc = load_flagship(n_chains)
    state = _initial_state(mc, cfg["run"], system, REPO)
    state = mc.quench(state, cfg["run"]["quench_steps"])
    state = state._replace(temp=temperature_ladder(
        250.0, 450.0, n_chains, dtype=state.temp.dtype))
    state = mc.run_steps(state, 2, False)
    xkey = jax.random.PRNGKey(21)

    ref, ref_fracs = state, []
    t0 = time.perf_counter()
    for r in range(n_rounds):
        ref = mc.run_steps(ref, sweeps_per_round, False)
        ref, frac = exchange(ref, jax.random.fold_in(xkey, r), r % 2)
        ref_fracs.append(float(frac))
    jax.block_until_ready(ref.energy)
    t_ref = time.perf_counter() - t0

    mesh = make_mesh(4)
    t0 = time.perf_counter()
    out, fracs = sharded_run_steps(mc, state, mesh,
                                   n_rounds * sweeps_per_round, False,
                                   remc_every=sweeps_per_round,
                                   remc_key=xkey, phase0=0)
    jax.block_until_ready(out.energy)
    t_sh = time.perf_counter() - t0
    e_ref, e_out = np.asarray(ref.energy), np.asarray(out.energy)
    bitwise = bool(np.array_equal(e_ref, e_out)
                   and np.array_equal(np.asarray(ref.coords),
                                      np.asarray(out.coords)))
    rel = float(np.max(np.abs(e_out - e_ref) / np.abs(e_ref)))
    acc_diff = int(np.sum(np.any(np.asarray(ref.acc)
                                 != np.asarray(out.acc), axis=1)))
    fracs = [float(f) for f in np.asarray(fracs)]
    emit("sharded_remc", n_chains=n_chains, devices=4, n_rounds=n_rounds,
         sweeps_per_round=sweeps_per_round, bitwise_equal=bitwise,
         energy_max_rel_diff=rel, energy_rel_tol=1e-5,
         chains_with_different_acceptances=acc_diff,
         swap_fracs=fracs, swap_fracs_unsharded=ref_fracs,
         wall_unsharded_s=t_ref, wall_sharded_s=t_sh)
    check(rel <= 1e-5 and acc_diff == 0, (rel, acc_diff))
    check(fracs == ref_fracs, (fracs, ref_fracs))
    check(all(0.0 < f < 1.0 for f in fracs), fracs)

    sub = jax.tree.map(lambda x: x[:n_tp] if getattr(x, "ndim", 0) else x,
                       out)
    e0, w0, _ = mc.full_energy(sub)
    fn = tp_full_energy_fn(system, params, make_mesh_2d(2, 2), mc.kvecs,
                           mc.kweights, recompute_chunk=4)
    e1, w1, _ = fn(sub.coords, sub.com, sub.box)
    e_rel = float(np.max(np.abs(np.asarray(e1) - np.asarray(e0))
                         / np.abs(np.asarray(e0))))
    w_rel = float(np.max(np.abs(np.asarray(w1) - np.asarray(w0))
                         / np.maximum(np.abs(np.asarray(w0)), 1.0)))
    emit("tensor_parallel_2x2", n_chains=n_tp, energy_max_rel_err=e_rel,
         virial_max_rel_err=w_rel, tol=1e-5)
    check(e_rel <= 1e-5, e_rel)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU path and its comparison")
    ap.add_argument("--out", default=os.path.join(REPO, "out", "chip_smoke"),
                    help="directory for the CLI run and the trace")
    args = ap.parse_args(argv)
    devs = require_gpu()
    os.makedirs(args.out, exist_ok=True)
    phase_device(devs)
    if args.four:
        if len(devs) < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
        phase_four()
    else:
        state = phase_flagship(args.out)
        mc = load_flagship()[3]
        state = phase_energy_reference(mc, state)
        phase_lj()
        phase_ensembles()
        phase_trace(mc, state, args.out)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
