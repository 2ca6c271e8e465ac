"""Command-line runner: `python -m metropolismontecarlo_tpu <config.json>`.

The top-level driver the reference implements as editable script globals +
`Loop(...)` (`Ewald/main.jl:62-107,460-696`), with the subsystems it only
TODOs: JSON config, symmetric checkpoint/resume, structured metrics, RDF
accumulation, and chain-parallel execution (optionally sharded over a
device mesh).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.io.checkpoint import load_state, save_state
from metropolismontecarlo_tpu.io.configs import cubic_lattice, read_cnf
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.energy import pressure as pressure_fn
from metropolismontecarlo_tpu.models.system import SimState
from metropolismontecarlo_tpu.observables import BlockAverager, RDFAccumulator
# NOTE: utils.config is imported as a MODULE and build_system is looked
# up at call time (run.py:497) — tests monkeypatch
# utils.config.build_system to drive ensemble branches with synthetic
# systems, and a from-import taken while the patch was live would pin
# the patched builder for the rest of the process (this exact leak
# silently rewired every later CLI run in a shard to a zero-charge LJ
# system; see tests/test_gibbs_binary.py::test_cli_gibbs_binary_end_to_end).
from metropolismontecarlo_tpu.utils import config as _config
from metropolismontecarlo_tpu.utils.cache import enable_compile_cache
from metropolismontecarlo_tpu.utils.config import (
    build_params,
    load_config,
)
from metropolismontecarlo_tpu.utils.logging import JsonlLogger, banner, block_line


def _start_box(run_cfg, system, base_dir):
    """The starting box edge implied by the run's start section (host
    float; used to tune Ewald parameters before building the driver).
    Must stay consistent with _initial_state, which derives its box
    through this function for the lattice kind and from the parsed
    file for nist/cnf (this re-parses — only paid when ewald_tol is
    set)."""
    start = run_cfg.get("start", {"kind": "lattice"})
    kind = start.get("kind", "lattice").lower()
    if kind == "lattice":
        if "box" in start and start["box"]:
            return float(start["box"])
        return (system.n_mol / float(start["density"])) ** (1.0 / 3.0)
    if kind == "nist":
        from metropolismontecarlo_tpu.models.water import spce_from_nist
        return float(spce_from_nist(os.path.join(base_dir,
                                                 start["path"]))[3])
    if kind == "cnf":
        return float(read_cnf(os.path.join(base_dir, start["path"]))[2])
    raise ValueError(f"unknown start kind {kind!r}")


def _initial_state(mc, run_cfg, system, base_dir):
    start = run_cfg.get("start", {"kind": "lattice"})
    kind = start.get("kind", "lattice").lower()
    seed = int(run_cfg.get("seed", 0))
    key = jax.random.PRNGKey(seed)
    n_chains = int(run_cfg.get("n_chains", 8))
    if kind == "lattice":
        box = _start_box(run_cfg, system, base_dir)
        com = cubic_lattice(system.n_mol, box)
        return mc.init_state(key, com, box=box, n_chains=n_chains)
    if kind == "nist":
        from metropolismontecarlo_tpu.models.water import spce_from_nist
        _, coords, com, box = spce_from_nist(
            os.path.join(base_dir, start["path"]))
        return mc.init_from_coords(key, coords, com, box, n_chains=n_chains)
    if kind == "cnf":
        com, quat, box = read_cnf(os.path.join(base_dir, start["path"]))
        return mc.init_state(key, (com + box / 2.0) % box, quat=quat,
                             box=box, n_chains=n_chains)
    raise ValueError(f"unknown start kind {kind!r}")


def _run_gcmc(cfg, system, params, dtype, args):
    """muVT loop: `"ensemble": {"kind": "gcmc", "activity": z,
    "capacity": cap, "box": L, "n_init": n}` in the run section.

    Monatomic systems use the slot LJ app (mc/gcmc.py); rigid molecular
    systems (P > 1, e.g. spce) the full molecular app (mc/gcmc_mol.py,
    orientational insertions + electrostatics) — there the model's
    n_mol IS the slot capacity, so it must equal ensemble.capacity.
    Optional `"p_exchange"` sets the exchange-attempt probability;
    `"n_orient"` the Rosenbluth trial count; `"bias": "pose"` widens
    the trials to full poses (positional/cavity bias)."""
    run_cfg = cfg.get("run", {})
    ens = run_cfg["ensemble"]
    if ens.get("kind") == "binary":
        from metropolismontecarlo_tpu.mc.gcmc_binary import BinaryGCMC
        g = BinaryGCMC(system, params,
                       activities=tuple(float(z)
                                        for z in ens["activities"]),
                       p_exchange=float(ens.get("p_exchange", 0.4)),
                       dtype=dtype, n_orient=int(ens.get("n_orient", 1)))
        state = g.init(jax.random.PRNGKey(int(run_cfg.get("seed", 0))),
                       box=float(ens["box"]),
                       n_init=tuple(int(n) for n in ens["n_init"]),
                       n_chains=int(run_cfg.get("n_chains", 8)))
        out_cfg = run_cfg.get("output", {})
        out_dir = out_cfg.get("dir")
        logger = JsonlLogger(os.path.join(out_dir, "metrics.jsonl")
                             if out_dir else None)
        n_blocks = int(run_cfg.get("n_blocks", 10))
        n_steps = int(run_cfg.get("n_steps", 1000))
        for block in range(n_blocks):
            state, stats = g.run_block(state, n_steps)
            if not args.quiet:
                print(f"blk {block:4d}  <N0> {stats['n0_mean']:8.2f}  "
                      f"<N1> {stats['n1_mean']:8.2f}  "
                      f"accX {stats['acc_insert0']:.3f}/"
                      f"{stats['acc_insert1']:.3f}  "
                      f"drift {stats['drift_max_rel']:.2e}")
            logger.write(dict(stats, block=block))
        logger.close()
        if not args.quiet:
            print("done.")
        return state
    if ens.get("kind") == "osmotic":
        from metropolismontecarlo_tpu.mc.gcmc_osmotic import OsmoticGCMC
        if "bias" in ens:
            raise ValueError("ensemble.bias applies only to molecular "
                             "GCMC (mc/gcmc_mol.py); the osmotic app "
                             "does not support cavity bias yet")
        g = OsmoticGCMC(system, params, activity=float(ens["activity"]),
                        p_exchange=float(ens.get("p_exchange", 0.3)),
                        dtype=dtype, n_orient=int(ens.get("n_orient", 1)))
    elif system.atoms_per_mol > 1:
        from metropolismontecarlo_tpu.mc.gcmc_mol import MolGCMC
        if int(ens["capacity"]) != system.n_mol:
            raise ValueError(
                f"molecular GCMC: model n_mol ({system.n_mol}) must equal "
                f"ensemble capacity ({ens['capacity']}) — the molecule "
                "slots ARE the system's molecules")
        g = MolGCMC(system, params, activity=float(ens["activity"]),
                    p_exchange=float(ens.get("p_exchange", 0.3)),
                    dtype=dtype, n_orient=int(ens.get("n_orient", 1)),
                    bias=ens.get("bias", "orientation"))
    else:
        from metropolismontecarlo_tpu.mc.gcmc import GCMC
        unsupported = {"p_exchange", "n_orient", "bias"} & set(ens)
        if unsupported:
            raise ValueError(
                f"ensemble keys {sorted(unsupported)} apply only to "
                "molecular (P > 1) GCMC; the monatomic app splits "
                "moves by params.p_translate and needs no orientations")
        g = GCMC(system, params, activity=float(ens["activity"]),
                 capacity=int(ens["capacity"]), dtype=dtype)
    state = g.init(jax.random.PRNGKey(int(run_cfg.get("seed", 0))),
                   box=float(ens["box"]), n_init=int(ens["n_init"]),
                   n_chains=int(run_cfg.get("n_chains", 8)))
    out_cfg = run_cfg.get("output", {})
    out_dir = out_cfg.get("dir")
    logger = JsonlLogger(os.path.join(out_dir, "metrics.jsonl")
                         if out_dir else None)
    averages = BlockAverager()
    n_blocks = int(run_cfg.get("n_blocks", 10))
    n_steps = int(run_cfg.get("n_steps", 1000))
    equil = int(run_cfg.get("equil_blocks", 0))
    for block in range(n_blocks):
        state, stats = g.run_block(state, n_steps)
        vol = float(ens["box"]) ** 3
        stats["density_mean"] = stats["n_mean"] / vol
        if not args.quiet:
            print(f"blk {block:4d}  <N> {stats['n_mean']:9.3f}  "
                  f"rho {stats['density_mean']:.5f}  "
                  f"accI {stats['acc_insert']:.3f}  "
                  f"accD {stats['acc_delete']:.3f}  "
                  f"full {stats['full_frac']:.3f}  "
                  f"drift {stats['drift_max_rel']:.2e}")
        logger.write(dict(stats, block=block,
                          phase="equil" if block < equil else "prod"))
        ck_every = int(out_cfg.get("checkpoint_every", 0))
        if out_dir and ck_every and (block + 1) % ck_every == 0:
            from metropolismontecarlo_tpu.io.checkpoint import (
                save_ensemble_state,
            )
            save_ensemble_state(os.path.join(out_dir, "checkpoint.npz"),
                                state, {"block": block})
        if block >= equil:
            averages.add(**stats)
    logger.close()
    if not args.quiet and averages.blocks:
        import math
        z = float(ens["activity"])
        rho = averages.mean("density_mean")
        mu = f"beta*mu_ex = ln(z/rho) = {math.log(z / rho):.4f}" \
            if rho > 0.0 else "beta*mu_ex undefined (<N> = 0)"
        print(f"production averages over {len(averages.blocks)} blocks: "
              f"<N> = {averages.mean('n_mean'):.3f} "
              f"+- {averages.sem('n_mean'):.3f}   " + mu)
        print("done.")
    return state


def _run_tmmc(cfg, system, params, dtype, args):
    """Flat-histogram muVT loop: `"ensemble": {"kind": "tmmc",
    "activity": z, "capacity": cap, "box": L, "n_init": n | [lo, hi],
    ...}` in the run section.

    Monatomic systems use mc/tmmc.TMMC; rigid molecular systems (P > 1)
    TMMCMol (there capacity must equal the model's n_mol).  Options:
      * `"n_init": [lo, hi]` — STRATIFIED per-chain starts
        (linspace over the N axis; see mc/tmmc.py for why);
      * `"melt_blocks"` (molecular only) — displacement/rotation-only
        blocks before exchanges open, so hot lattice starts relax at
        fixed N instead of evaporating (the tmmc_water.txt protocol);
      * `"discard_blocks"` — burn-in discard: reset the collection
        matrix after that many TM blocks (lattice-start deposits
        otherwise pollute ln Pi permanently);
      * `"p_exchange"`, `"n_orient"` as in molecular GCMC;
      * `"coexistence": true` — solve equal basin weights at the end
        and report (z*, rho_vap, rho_liq, gamma).
    Writes lnpi.txt (N, ln Pi) to output.dir.
    """
    import numpy as _np

    from metropolismontecarlo_tpu.mc.tmmc import (
        TMMC,
        TMMCMol,
        coexistence,
        surface_tension,
    )

    run_cfg = cfg.get("run", {})
    ens = run_cfg["ensemble"]
    n_chains = int(run_cfg.get("n_chains", 8))
    box = float(ens["box"])
    molecular = system.atoms_per_mol > 1
    if molecular:
        if int(ens["capacity"]) != system.n_mol:
            raise ValueError(
                f"molecular TMMC: model n_mol ({system.n_mol}) must "
                f"equal ensemble capacity ({ens['capacity']})")
        t = TMMCMol(system, params, activity=float(ens["activity"]),
                    p_exchange=float(ens.get("p_exchange", 0.3)),
                    dtype=dtype, n_orient=int(ens.get("n_orient", 1)))
    else:
        if "melt_blocks" in ens:
            raise ValueError("melt_blocks applies only to molecular "
                             "TMMC (monatomic lattice starts relax "
                             "within the first block)")
        t = TMMC(system, params, activity=float(ens["activity"]),
                 capacity=int(ens["capacity"]), dtype=dtype)
    n_init = ens["n_init"]
    if isinstance(n_init, (list, tuple)):
        lo, hi = n_init
        n_init = _np.linspace(float(lo), float(hi),
                              n_chains).astype(_np.int32)
    else:
        n_init = int(n_init)
    seed = int(run_cfg.get("seed", 0))
    state = t.init(jax.random.PRNGKey(seed), box=box, n_init=n_init,
                   n_chains=n_chains)

    out_cfg = run_cfg.get("output", {})
    out_dir = out_cfg.get("dir")
    logger = JsonlLogger(os.path.join(out_dir, "metrics.jsonl")
                         if out_dir else None)
    n_blocks = int(run_cfg.get("n_blocks", 10))
    n_steps = int(run_cfg.get("n_steps", 1000))
    melt = int(ens.get("melt_blocks", 0))
    discard = int(ens.get("discard_blocks", 0))

    if melt:
        from metropolismontecarlo_tpu.mc.gcmc_mol import MolGCMC
        g0 = MolGCMC(system, params, activity=float(ens["activity"]),
                     p_exchange=0.0, dtype=dtype)
        for block in range(melt):
            state, stats = g0.run_block(state, n_steps)
            if not args.quiet:
                print(f"melt {block:4d}  <E> {stats['energy_mean']:.1f}"
                      f"  accT {stats['acc_trans']:.3f}  "
                      f"drift {stats['drift_max_rel']:.2e}")
            logger.write(dict(stats, block=block, phase="melt"))

    for block in range(n_blocks):
        state, stats = t.run_block(state, n_steps)
        if block + 1 == discard:
            t.reset_collection()
        if not args.quiet:
            print(f"blk {block:4d}  N [{stats['n_min']},"
                  f"{stats['n_max']}]  <N> {stats['n_mean']:8.2f}  "
                  f"visited {stats['visited_frac']:.2f}  "
                  f"accI {stats['acc_insert']:.3f}  "
                  f"accD {stats['acc_delete']:.3f}  "
                  f"drift {stats['drift_max_rel']:.2e}")
        logger.write(dict(stats, block=block,
                          phase="burnin" if block < discard else "prod"))

    lnpi = t.lnpi()
    if out_dir:
        fin = _np.isfinite(lnpi)
        with open(os.path.join(out_dir, "lnpi.txt"), "w") as f:
            f.write("# N  lnPi  (z0 = %g)\n" % t.activity)
            for n_, v in zip(_np.where(fin)[0], lnpi[fin]):
                f.write(f"{n_} {v:.8f}\n")
    if ens.get("coexistence"):
        try:
            res = coexistence(lnpi, t.activity, box**3)
            gamma = surface_tension(res["lnpi_coex"], box,
                                    params.temperature)
            if not args.quiet:
                print(f"coexistence: z* = {res['z_coex']:.6g}  "
                      f"rho_vap = {res['rho_vap']:.6g}  "
                      f"rho_liq = {res['rho_liq']:.6g}  "
                      f"gamma = {gamma:.6g}")
            logger.write({"phase": "coexistence",
                          "z_coex": res["z_coex"],
                          "rho_vap": res["rho_vap"],
                          "rho_liq": res["rho_liq"],
                          "gamma": gamma})
        except ValueError as err:
            print(f"coexistence solve failed: {err}")
    logger.close()
    if not args.quiet:
        print("done.")
    return state


def _run_semigrand(cfg, system, params, dtype, args):
    """Semigrand loop: `"ensemble": {"kind": "semigrand",
    "fugacity_ratio": xi, "box": L, "n_a": n, "n_b": m,
    "p_flip": 0.3, "n_orient": 1}` in the run section."""
    from metropolismontecarlo_tpu.mc.semigrand import Semigrand

    run_cfg = cfg.get("run", {})
    ens = run_cfg["ensemble"]
    g = Semigrand(system, params,
                  fugacity_ratio=float(ens["fugacity_ratio"]),
                  p_flip=float(ens.get("p_flip", 0.3)), dtype=dtype,
                  n_orient=int(ens.get("n_orient", 1)))
    state = g.init(jax.random.PRNGKey(int(run_cfg.get("seed", 0))),
                   box=float(ens["box"]), n_a=int(ens["n_a"]),
                   n_b=int(ens["n_b"]),
                   n_chains=int(run_cfg.get("n_chains", 8)))
    out_cfg = run_cfg.get("output", {})
    out_dir = out_cfg.get("dir")
    logger = JsonlLogger(os.path.join(out_dir, "metrics.jsonl")
                         if out_dir else None)
    averages = BlockAverager()
    n_blocks = int(run_cfg.get("n_blocks", 10))
    n_steps = int(run_cfg.get("n_steps", 1000))
    equil = int(run_cfg.get("equil_blocks", 0))
    for block in range(n_blocks):
        state, stats = g.run_block(state, n_steps)
        if not args.quiet:
            print(f"blk {block:4d}  <N_B> {stats['nb_mean']:9.3f}  "
                  f"x_B {stats['nb_mean'] / stats['n_tot_mean']:.4f}  "
                  f"accAB {stats['acc_flip_ab']:.3f}  "
                  f"accBA {stats['acc_flip_ba']:.3f}  "
                  f"drift {stats['drift_max_rel']:.2e}")
        logger.write(dict(stats, block=block,
                          phase="equil" if block < equil else "prod"))
        ck_every = int(out_cfg.get("checkpoint_every", 0))
        if out_dir and ck_every and (block + 1) % ck_every == 0:
            from metropolismontecarlo_tpu.io.checkpoint import (
                save_ensemble_state,
            )
            save_ensemble_state(os.path.join(out_dir, "checkpoint.npz"),
                                state, {"block": block})
        if block >= equil:
            averages.add(**stats)
    logger.close()
    if not args.quiet and averages.blocks:
        print(f"production averages over {len(averages.blocks)} blocks: "
              f"<N_B> = {averages.mean('nb_mean'):.3f} "
              f"+- {averages.sem('nb_mean'):.3f}")
        print("done.")
    return state


def _run_gibbs(cfg, system, params, dtype, args):
    """Gibbs-ensemble loop: `"ensemble": {"kind": "gibbs",
    "boxes": [L1, L2], "n_init": [n1, n2], "capacity": 256,
    "dv_max": 0.03}` in the run section.

    Monatomic systems use the slot LJ app (mc/gibbs.py); rigid molecular
    systems the full molecular app (mc/gibbs_mol.py, orientational
    transfers + electrostatics) — there the model's n_mol IS the
    per-box capacity, so it must equal ensemble.capacity.  Optional
    `"p_transfer"` sets the transfer-attempt probability."""
    run_cfg = cfg.get("run", {})
    ens = run_cfg["ensemble"]
    binary = ens.get("kind") == "gibbs_binary"
    if binary:
        # two-species two-box coexistence: `{"kind": "gibbs_binary",
        # "boxes": [L1, L2], "n_init": [[nA1, nA2], [nB1, nB2]]}` on a
        # two-species-block model (e.g. a 2-molecule-type topology)
        from metropolismontecarlo_tpu.mc.gibbs_binary import (
            BinaryGibbsEnsemble,
        )
        # optional "pressure" (K/A^3): constant-pressure Gibbs for
        # mixtures — per-box volume moves against the bath instead of
        # the coupled dV transfer (see make_gibbs_binary npt_pressure)
        npt_p = ens.get("pressure")
        g = BinaryGibbsEnsemble(
            system, params, dv_max=float(ens.get("dv_max", 0.03)),
            p_transfer=float(ens.get("p_transfer", 0.3)), dtype=dtype,
            n_orient=int(ens.get("n_orient", 1)),
            npt_pressure=float(npt_p) if npt_p is not None else None)
        state = g.init(jax.random.PRNGKey(int(run_cfg.get("seed", 0))),
                       boxes=tuple(float(b) for b in ens["boxes"]),
                       n_init=[[int(n) for n in row]
                               for row in ens["n_init"]],
                       n_chains=int(run_cfg.get("n_chains", 8)))
    elif system.atoms_per_mol > 1:
        from metropolismontecarlo_tpu.mc.gibbs_mol import MolGibbsEnsemble
        if int(ens["capacity"]) != system.n_mol:
            raise ValueError(
                f"molecular Gibbs: model n_mol ({system.n_mol}) must "
                f"equal ensemble capacity ({ens['capacity']}) — the "
                "molecule slots ARE the system's molecules")
        g = MolGibbsEnsemble(system, params,
                             dv_max=float(ens.get("dv_max", 0.03)),
                             p_transfer=float(ens.get("p_transfer", 0.3)),
                             dtype=dtype,
                             n_orient=int(ens.get("n_orient", 1)))
    else:
        from metropolismontecarlo_tpu.mc.gibbs import GibbsEnsemble
        unsupported = {"p_transfer", "n_orient"} & set(ens)
        if unsupported:
            raise ValueError(
                f"ensemble keys {sorted(unsupported)} apply only to "
                "molecular (P > 1) Gibbs; the monatomic app splits "
                "moves by params.p_translate and needs no orientations")
        g = GibbsEnsemble(system, params, capacity=int(ens["capacity"]),
                          dv_max=float(ens.get("dv_max", 0.03)),
                          dtype=dtype)
    if not binary:
        state = g.init(jax.random.PRNGKey(int(run_cfg.get("seed", 0))),
                       boxes=tuple(float(b) for b in ens["boxes"]),
                       n_init=tuple(int(n) for n in ens["n_init"]),
                       n_chains=int(run_cfg.get("n_chains", 8)))
    out_cfg = run_cfg.get("output", {})
    out_dir = out_cfg.get("dir")
    logger = JsonlLogger(os.path.join(out_dir, "metrics.jsonl")
                         if out_dir else None)
    averages = BlockAverager()
    n_blocks = int(run_cfg.get("n_blocks", 10))
    n_steps = int(run_cfg.get("n_steps", 10000))
    equil = int(run_cfg.get("equil_blocks", 0))
    for block in range(n_blocks):
        state, stats = g.run_block(state, n_steps)
        if not args.quiet and binary:
            print(f"blk {block:4d}  rho_l {stats['rho_liq']:.4f}  "
                  f"rho_v {stats['rho_vap']:.4f}  "
                  f"x0_l {stats['x0_liq']:.3f}  "
                  f"x0_v {stats['x0_vap']:.3f}  "
                  f"accX {stats['acc_transfer0']:.3f}/"
                  f"{stats['acc_transfer1']:.3f}  "
                  f"accV {stats['acc_vol']:.3f}  "
                  f"drift {stats['drift_max_rel']:.2e}")
        elif not args.quiet:
            print(f"blk {block:4d}  rho_l {stats['rho_liq']:.4f}  "
                  f"rho_v {stats['rho_vap']:.4f}  "
                  f"accX {stats['acc_transfer']:.3f}  "
                  f"accV {stats['acc_vol']:.3f}  "
                  f"full {stats['full_frac']:.3f}  "
                  f"drift {stats['drift_max_rel']:.2e}")
        logger.write(dict({k: v for k, v in stats.items()
                           if not isinstance(v, list)}, block=block,
                          phase="equil" if block < equil else "prod"))
        ck_every = int(out_cfg.get("checkpoint_every", 0))
        if out_dir and ck_every and (block + 1) % ck_every == 0:
            from metropolismontecarlo_tpu.io.checkpoint import (
                save_ensemble_state,
            )
            save_ensemble_state(os.path.join(out_dir, "checkpoint.npz"),
                                state, {"block": block})
        if block >= equil:
            averages.add(**{k: v for k, v in stats.items()
                            if isinstance(v, float)})
    logger.close()
    if not args.quiet and averages.blocks:
        print(f"production averages over {len(averages.blocks)} blocks: "
              f"rho_liq = {averages.mean('rho_liq'):.4f} "
              f"+- {averages.sem('rho_liq'):.4f}   "
              f"rho_vap = {averages.mean('rho_vap'):.4f} "
              f"+- {averages.sem('rho_vap'):.4f}")
        print("done.")
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(prog="metropolismontecarlo_tpu")
    ap.add_argument("config", help="JSON run configuration")
    ap.add_argument("--resume", help="checkpoint .npz to resume from")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    enable_compile_cache()

    cfg = load_config(args.config)
    base_dir = os.path.dirname(os.path.abspath(args.config))
    run_cfg = cfg.get("run", {})
    out_cfg = run_cfg.get("output", {})
    out_dir = out_cfg.get("dir")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    if not args.quiet:
        banner()

    system = _config.build_system(cfg, base_dir)
    params = build_params(cfg)
    ewald_tol = cfg.get("params", {}).get("ewald_tol")
    if ewald_tol and params.coulomb == "ewald":
        import dataclasses

        from metropolismontecarlo_tpu.ops.ewald import tune_parameters
        # ensemble sections size the box themselves (no start section);
        # Gibbs tunes at the LARGEST box the volume exchange can reach
        # ((V1+V2)^(1/3), one box absorbing all volume): kappa =
        # kappa_L/box shrinks with box, so erfc(kappa*r_cut) — the
        # real-space truncation the consistency guard checks — is worst
        # in the big box, and tune_parameters' nk also grows with its
        # box argument (docs/validation/run_gibbs_water.py uses the
        # same l_max; gibbs_mol.check_ewald_consistency would reject a
        # min-box tuning at the first volume exchange)
        ens0 = run_cfg.get("ensemble")
        if ens0 and "box" in ens0:
            box0 = float(ens0["box"])
        elif ens0 and "boxes" in ens0:
            box0 = float(sum(float(b) ** 3
                             for b in ens0["boxes"])) ** (1.0 / 3.0)
            if "pressure" in ens0:
                # NPT-Gibbs: per-box ln-V moves against the bath are NOT
                # bounded by the initial total volume — tune with head-
                # room (1.4x the larger initial box, matching the
                # validation runner's hand-tuning margin) so a growing
                # box cannot trip check_ewald_consistency mid-run
                box0 = max(box0,
                           1.4 * max(float(b) for b in ens0["boxes"]))
        else:
            box0 = _start_box(run_cfg, system, base_dir)
        kl, nk, ksq = tune_parameters(box0, params.qq_cut,
                                      float(ewald_tol))
        params = dataclasses.replace(params, kappa_L=kl, nk=nk,
                                      ksq_max=ksq)
        if not args.quiet:
            print(f"ewald tuned to tol {ewald_tol:g} at box {box0:.3f}: "
                  f"kappa_L = {kl:.3f}, nk = {nk}, ksq_max = {ksq}")
    dtype = jnp.float64 if run_cfg.get("dtype") == "float64" else jnp.float32
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)
    rc = run_cfg.get("recompute_chunk", "auto")
    # optional per-chain pressure ladder (one-run isotherm/EOS scans):
    # "pressure_ladder": {"p_min": ..., "p_max": ..., "spacing":
    # "geometric"|"linear"} — pressures in K/A^3 like params.pressure
    pl_cfg = run_cfg.get("pressure_ladder")
    pressure_ladder = None
    if pl_cfg:
        n_chains = int(run_cfg.get("n_chains", 8))
        lo, hi = float(pl_cfg["p_min"]), float(pl_cfg["p_max"])
        if pl_cfg.get("spacing", "geometric") == "geometric":
            pressure_ladder = np.geomspace(lo, hi, n_chains)
        else:
            pressure_ladder = np.linspace(lo, hi, n_chains)
    mc = MonteCarlo(system, params, dtype=dtype,
                    recompute_chunk=rc if rc in ("auto", None) else int(rc),
                    pressure_ladder=pressure_ladder)

    ens = run_cfg.get("ensemble")
    if ens and ens.get("kind") in ("gcmc", "osmotic", "binary"):
        return _run_gcmc(cfg, system, params, dtype, args)
    if ens and ens.get("kind") == "tmmc":
        return _run_tmmc(cfg, system, params, dtype, args)
    if ens and ens.get("kind") in ("gibbs", "gibbs_binary"):
        return _run_gibbs(cfg, system, params, dtype, args)
    if ens and ens.get("kind") == "semigrand":
        return _run_semigrand(cfg, system, params, dtype, args)

    if args.resume:
        state_np, meta = load_state(args.resume)
        state = SimState(*[jnp.asarray(x) for x in state_np])
        first_block = int(meta.get("block", 0))
        print(f"resumed from {args.resume} at block {first_block}")
    else:
        state = _initial_state(mc, run_cfg, system, base_dir)
        first_block = 0

    # optional replica-exchange ladder across chains
    remc_cfg = run_cfg.get("remc")
    if remc_cfg and not args.resume:
        from metropolismontecarlo_tpu.parallel.remc import temperature_ladder
        ladder = temperature_ladder(
            float(remc_cfg["t_min"]), float(remc_cfg["t_max"]),
            state.temp.shape[0]).astype(state.temp.dtype)
        state = state._replace(temp=ladder)

    quench_steps = int(run_cfg.get("quench_steps", 0))
    if quench_steps and not args.resume:
        state = mc.quench(state, quench_steps)

    # optional simulated-annealing schedule: geometric interpolation of
    # the per-chain temperature from t_start to params.temperature over
    # the equilibration blocks
    anneal_cfg = run_cfg.get("anneal")

    rdf = None
    if "rdf" in out_cfg:
        r = out_cfg["rdf"]
        rdf = RDFAccumulator(system, int(r.get("type_i", 0)),
                             int(r.get("type_j", 0)),
                             float(r.get("r_max", params.r_cut)),
                             int(r.get("n_bins", 200)))
    sk = None
    if "sk" in out_cfg:
        from metropolismontecarlo_tpu.observables import (
            StructureFactorAccumulator,
        )
        s = out_cfg["sk"]
        sk = StructureFactorAccumulator(
            system, type_sel=s.get("type"), n_max=int(s.get("n_max", 6)),
            chunk=mc.recompute_chunk)
    # fluctuation observables (beyond-parity; production blocks only,
    # skipped automatically for multi-temperature REMC ladders)
    dipole = cvacc = None
    if out_cfg.get("dielectric") and not remc_cfg:
        from metropolismontecarlo_tpu.observables import DipoleAccumulator
        dipole = DipoleAccumulator(system, chunk=mc.recompute_chunk)
    if out_cfg.get("heat_capacity") and not remc_cfg:
        from metropolismontecarlo_tpu.observables import EnergyFluctuations
        cvacc = EnergyFluctuations()
    nptfl = None
    if out_cfg.get("npt_fluctuations") and not remc_cfg \
            and params.p_volume > 0 and pressure_ladder is None:
        from metropolismontecarlo_tpu.observables import NPTFluctuations
        nptfl = NPTFluctuations(pressure=params.pressure)
    widom_cfg = out_cfg.get("widom")
    widom_b = []

    logger = JsonlLogger(os.path.join(out_dir, "metrics.jsonl")
                         if out_dir else None)
    averages = BlockAverager()
    n_blocks = int(run_cfg.get("n_blocks", 10))
    n_steps = int(run_cfg.get("n_steps", 100))
    equil = int(run_cfg.get("equil_blocks", 0))
    pdb_every = int(out_cfg.get("pdb_every", 0))
    ckpt_every = int(out_cfg.get("checkpoint_every", 0))

    for block in range(first_block, n_blocks):
        adjust = block < equil
        if anneal_cfg and adjust and equil > 0:
            frac = block / max(equil - 1, 1)
            t_b = float(anneal_cfg["t_start"]) * (
                params.temperature / float(anneal_cfg["t_start"])) ** frac
            state = state._replace(temp=jnp.full_like(state.temp, t_b))
        elif anneal_cfg and block == equil:
            state = state._replace(
                temp=jnp.full_like(state.temp, params.temperature))
        state, metrics = mc.run_block(state, n_steps, adjust=adjust)
        if remc_cfg:
            from metropolismontecarlo_tpu.parallel.remc import exchange
            xkey = jax.random.fold_in(
                jax.random.PRNGKey(int(run_cfg.get("seed", 0)) + 7919), block)
            # structure factors/energies swap WITH the configurations, so
            # no resync is needed after an exchange round
            state, swap_frac = exchange(state, xkey, block % 2)
            metrics["remc_swap_frac"] = float(swap_frac)
        vol = float(jnp.mean(state.box**3))
        # EXACT dU/dV pressure: state.virial carries the closed-form
        # molecular virial (incl. the reciprocal-Ewald term) computed for
        # free in the block-end recompute — no extra FD recomputes needed
        # (validated against MonteCarlo.pressure_fd in tests/test_mc.py).
        # pressure_trunc_corr is the impulsive cutoff-crossing term
        # (g~1 approx) to ADD for the thermodynamic pressure of
        # cut-unshifted LJ (reference `pressure_delta` parity).
        metrics["pressure_mean"] = float(pressure_fn(
            params, system.n_mol, vol, metrics["virial_mean"]))
        if params.lj_shift == "none":
            from metropolismontecarlo_tpu.ops.tail import impulsive_pressure
            metrics["pressure_trunc_corr"] = float(impulsive_pressure(
                np.asarray(system.type_counts, np.float64),
                jnp.asarray(system.eps_table, dtype),
                jnp.asarray(system.sig_table, dtype),
                params.r_cut, vol))
        if rdf is not None and not adjust:
            rdf.update(state)
        if sk is not None and not adjust:
            sk.update(state)
        if not adjust:
            if dipole is not None:
                dipole.update(state)
                metrics["epsilon_running"] = dipole.result()["epsilon"]
            if cvacc is not None:
                cvacc.update(state)
            if nptfl is not None:
                nptfl.update(state)
            if widom_cfg:
                wkey = jax.random.fold_in(jax.random.PRNGKey(
                    int(run_cfg.get("seed", 0)) + 104729), block)
                w = mc.widom(state, wkey,
                             n_insertions=int(widom_cfg.get("n_insertions",
                                                            64)),
                             species=int(widom_cfg.get("species", 0)))
                bmean = float(jnp.mean(w["boltzmann_mean"]))
                widom_b.append(bmean)
                metrics["widom_boltzmann_mean"] = bmean
        if not args.quiet:
            print(block_line(block, metrics))
        logger.write(dict(metrics, block=block, phase="equil" if adjust else "prod"))
        if not adjust:
            averages.add(**{k: v for k, v in metrics.items()
                            if isinstance(v, float)})
        if out_dir and pdb_every and (block + 1) % pdb_every == 0:
            from metropolismontecarlo_tpu.io.pdb import write_pdb
            tid = system.flat(system.type_ids)
            names = [f"T{t}" for t in tid]
            res = system.atom_mol_slot[0] + 1
            write_pdb(os.path.join(out_dir, f"frame_{block + 1}.pdb"),
                      np.asarray(state.coords[0]).T[: system.n_atoms], names,
                      [system.name[:3].upper()] * system.n_atoms, res,
                      box=float(state.box[0]))
        if out_dir and ckpt_every and (block + 1) % ckpt_every == 0:
            save_state(os.path.join(out_dir, "checkpoint.npz"), state,
                       metadata={"block": block + 1})

    if rdf is not None and out_dir:
        r, g = rdf.result()
        np.savetxt(os.path.join(out_dir, "rdf.txt"),
                   np.column_stack([r, g]), header="r g(r)")
    if sk is not None and out_dir and sk.n_samples:
        k, s = sk.result()
        np.savetxt(os.path.join(out_dir, "sk.txt"),
                   np.column_stack([k, s]), header="k S(k)")
    final_obs = {}
    if dipole is not None and dipole.n_samples:
        d = dipole.result()
        final_obs.update(epsilon=d["epsilon"], g_kirkwood=d["g_kirkwood"])
    if cvacc is not None and cvacc.n_samples > 1:
        final_obs["cv_excess"] = cvacc.result()["cv_excess"]
    if nptfl is not None and nptfl.n > 1:
        f = nptfl.result()
        final_obs.update(kappa_T=f["kappa_T"], alpha_P=f["alpha_P"],
                         cp_conf=f["cp_conf"])
    if widom_b:
        from metropolismontecarlo_tpu.mc.widom import mu_excess
        bmean = float(np.mean(widom_b))
        final_obs["widom_boltzmann_mean"] = bmean
        final_obs["mu_excess"] = float(mu_excess(
            jnp.asarray(bmean), params.temperature))
    if final_obs:
        logger.write(dict(final_obs, phase="final"))
        if not args.quiet:
            print("observables: " + "  ".join(
                f"{k} = {v:.6g}" for k, v in final_obs.items()))
    if out_dir:
        save_state(os.path.join(out_dir, "final.npz"), state,
                   metadata={"block": n_blocks})
    logger.close()
    if not args.quiet and averages.blocks:
        # blocking-plateau errors when the block series is long enough
        # to resolve its own autocorrelation (observables.blocking_analysis)
        print(f"production averages over {len(averages.blocks)} blocks: "
              f"<E> = {averages.mean('energy_mean'):.4f} "
              f"+- {averages.sem_blocking('energy_mean'):.4f}   "
              f"<P> = {averages.mean('pressure_mean'):.6f} "
              f"+- {averages.sem_blocking('pressure_mean'):.6f}")
        print("done.")
    elif not args.quiet:
        print("done.")
    return state


if __name__ == "__main__":
    main()
