"""Every shipped configuration that needs no external input file builds
its system and its state from its seed through the CLI; the ones that
read a GROMACS topology fail with a message naming the missing file."""

import json
import os

import numpy as np
import pytest

from metropolismontecarlo_tpu import run as cli
from metropolismontecarlo_tpu.utils.config import build_system, load_config

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
SHIPPED = sorted(f for f in os.listdir(CONFIG_DIR) if f.endswith(".json"))
TOPOLOGY = [f for f in SHIPPED
            if load_config(os.path.join(CONFIG_DIR, f))["model"]["kind"]
            == "topology"]
SEEDED = [f for f in SHIPPED if f not in TOPOLOGY]


def _build(name, tmp_path, n_chains=2):
    """Run the CLI on `name` cut to zero blocks (one short block for
    TMMC) and n_chains chains; returns the final state."""
    cfg = load_config(os.path.join(CONFIG_DIR, name))
    run = cfg["run"]
    run.update(n_chains=n_chains, n_blocks=0, quench_steps=0)
    run["output"] = {"dir": str(tmp_path / "out")}
    ens = run.get("ensemble")
    if ens and ens["kind"] == "tmmc":
        # ln Pi needs one block of collected transitions
        run.update(n_blocks=1, n_steps=20)
        ens.pop("melt_blocks", None)
        ens["coexistence"] = False
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return cli.main([str(path), "--quiet"])


def test_shipped_config_lists_are_complete():
    assert len(SEEDED) == 12 and len(TOPOLOGY) == 4, (SEEDED, TOPOLOGY)


@pytest.mark.parametrize("name", SEEDED)
def test_shipped_config_builds_from_seed(name, tmp_path):
    state = _build(name, tmp_path)
    for field in state:
        if hasattr(field, "dtype") and np.issubdtype(field.dtype,
                                                     np.floating):
            assert np.all(np.isfinite(np.asarray(field))), name
    assert np.asarray(state.energy).shape[0] == 2


def test_seeded_start_is_reproducible(tmp_path):
    a = _build("lj_fluid.json", tmp_path / "a")
    b = _build("lj_fluid.json", tmp_path / "b")
    np.testing.assert_array_equal(np.asarray(a.coords), np.asarray(b.coords))
    np.testing.assert_array_equal(np.asarray(a.energy), np.asarray(b.energy))


@pytest.mark.parametrize("name", TOPOLOGY)
def test_topology_config_names_missing_file(name, tmp_path):
    cfg = load_config(os.path.join(CONFIG_DIR, name))
    missing = os.path.join(str(tmp_path), "absent", "topol.top")
    cfg["model"]["top"] = missing
    with pytest.raises(FileNotFoundError, match="absent/topol.top"):
        build_system(cfg, CONFIG_DIR)
