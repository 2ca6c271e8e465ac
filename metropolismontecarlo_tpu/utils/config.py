"""JSON run-configuration layer.

The reference configures runs by editing globals at the top of each main
file and lists JSON input as a TODO (`Ewald/main.jl:49,62-107`); this
module honors that TODO: one JSON document describes the model, the
RunParams, and the run schedule.

Schema (all sections optional except model):
{
  "model": {"kind": "spce"|"tip3p"|"tip4p2005"|"tip4pew"|"tip4pice"|
                    "co2"|"n2"|"lj"|"triatomic"|"topology",
            "n_mol": 750,                        // spce/tip3p/lj/triatomic
            "top": "topol.top",                  // topology kind
            "templates": {"SOL": "tip3p.pdb"},   // topology kind
            "molecules": [["SOL", 100]]},        // optional override
  "params": { ... RunParams fields ...,
              "ewald_tol": 1e-5 },  // optional: accuracy-targeted
                                    // kappa_L/nk/ksq_max at the start
                                    // box (ops.ewald.tune_parameters)
  "run":   {"n_chains": 64, "n_blocks": 10, "n_steps": 100,
            "equil_blocks": 2, "seed": 0, "dtype": "float32",
            "pressure_ladder": {"p_min": 1e-5, "p_max": 1e-3,
                                "spacing": "geometric"},  // per-chain
                                // isobars (one-run EOS; K/A^3)
            "ensemble": {"kind": "gcmc", "activity": 0.05,  // muVT mode
                         "capacity": 96, "box": 8.0, "n_init": 30,
                         "n_orient": 8, "bias": "pose"},  // Rosenbluth
                                     // k-trials; "pose" = cavity bias
                        // or {"kind": "gibbs", "boxes": [L1, L2],
                        //     "n_init": [n1, n2], "capacity": 256,
                        //     "dv_max": 0.03}  (two-box coexistence)
                        // or {"kind": "binary",          // 2-species
                        //     "activities": [z0, z1],    // muVT (both
                        //     "box": 10.0, "n_init": [8, 8]}  // exch.)
                        // or {"kind": "tmmc", "activity": 0.03,
                        //     "capacity": 192, "box": 6.0,
                        //     "n_init": [2, 180],   // stratified
                        //     "discard_blocks": 12, "melt_blocks": 8,
                        //     "coexistence": true}  (flat-histogram
                        //     muVT -> lnpi.txt + equal-weight solve)
                        // (omit section entirely for NVT/NPT)
            "start": {"kind": "lattice"|"nist"|"cnf", "path": "...",
                      "box": 20.0, "density": null},
            "output": {"dir": "out", "pdb_every": 0,
                       "checkpoint_every": 0,
                       "rdf": {"type_i": 0, "type_j": 0,
                               "r_max": 10.0, "n_bins": 200},
                       "sk": {"type": null, "n_max": 6}, // S(k) shells

                       "dielectric": false,      // dipole-fluctuation eps
                       "heat_capacity": false,   // C_v,ex from <dE^2>
                       "npt_fluctuations": false, // kappa_T, alpha_P,
                                                  // cp_conf (NPT runs)
                       "widom": {"n_insertions": 64, "species": 0}}}
}
"""

import dataclasses
import json
import os

from metropolismontecarlo_tpu.models.system import RunParams


def load_config(path):
    with open(path) as f:
        cfg = json.load(f)
    return cfg


def build_params(cfg):
    """RunParams from the "params" section.  One pseudo-field:
    "ewald_tol" requests accuracy-targeted kappa_L/nk/ksq_max via
    ops.ewald.tune_parameters — it needs the start box, so the runner
    applies it after the start geometry is known (run.py)."""
    fields = {f.name for f in dataclasses.fields(RunParams)}
    given = dict(cfg.get("params", {}))
    given.pop("ewald_tol", None)
    unknown = set(given) - fields
    if unknown:
        raise ValueError(f"unknown RunParams fields: {sorted(unknown)}")
    return RunParams(**given)


def build_system(cfg, base_dir="."):
    model = cfg["model"]
    kind = model["kind"].lower()
    if kind == "spce":
        from metropolismontecarlo_tpu.models.water import spce_system
        return spce_system(int(model["n_mol"]))
    if kind == "tip3p":
        from metropolismontecarlo_tpu.models.water import tip3p_system
        return tip3p_system(int(model["n_mol"]))
    if kind in ("tip4p2005", "tip4pew", "tip4pice"):
        from metropolismontecarlo_tpu.models import water as water_models
        builder = {"tip4p2005": water_models.tip4p2005_system,
                   "tip4pew": water_models.tip4pew_system,
                   "tip4pice": water_models.tip4pice_system}[kind]
        return builder(int(model["n_mol"]))
    if kind in ("co2", "n2"):
        from metropolismontecarlo_tpu.models import linear as linear_models
        builder = {"co2": linear_models.co2_system,
                   "n2": linear_models.n2_system}[kind]
        return builder(int(model["n_mol"]))
    if kind == "lj":
        from metropolismontecarlo_tpu.models.monatomic import lj_system
        return lj_system(int(model["n_mol"]),
                         eps=model.get("eps", 1.0), sigma=model.get("sigma", 1.0))
    if kind == "triatomic":
        from metropolismontecarlo_tpu.models.polyatomic import triatomic_system
        return triatomic_system(int(model["n_mol"]),
                                alpha_deg=model.get("alpha_deg", 75.0))
    if kind == "topology":
        from metropolismontecarlo_tpu.io.topology import read_top
        from metropolismontecarlo_tpu.models.from_topology import (
            system_from_topology,
            templates_from_pdbs,
        )
        top_path = os.path.join(base_dir, model["top"])
        pdbs = {k: os.path.join(base_dir, v)
                for k, v in model["templates"].items()}
        for path in [top_path, *pdbs.values()]:
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"topology model input {path} does not exist; this "
                    "configuration needs the GROMACS topology and its PDB "
                    "templates")
        top = read_top(top_path, defines=model.get("defines", ()))
        templates = templates_from_pdbs(top, pdbs)
        molecules = [tuple(x) for x in model["molecules"]] \
            if "molecules" in model else None
        return system_from_topology(top, templates, molecules=molecules,
                                    name=kind)
    raise ValueError(f"unknown model kind {kind!r}")
