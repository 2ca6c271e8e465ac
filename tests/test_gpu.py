"""Card tests: the f32 jnp move path on a CUDA device against the float64
NumPy reference, on the flagship SPC/E 750-water Ewald model and on the
256-atom LJ fluid.  Run with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

and skipped (by the gpu_device fixture) on the default CPU run."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.energy import energy_breakdown_jit
from metropolismontecarlo_tpu.models.monatomic import (
    lj_box_for_density,
    lj_system,
)
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.reference import energy_components

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per component relative to its own magnitude; totals relative to the sum
# of component magnitudes (see chip_smoke.py REL_TOL)
REL_TOL = 2e-5

pytestmark = pytest.mark.gpu


def _check(mc, state, chains=(0, 1)):
    A = mc.system.n_atoms
    for c in chains:
        coords = state.coords[c, :, :A].T
        out = energy_breakdown_jit(mc.system, mc.params, coords,
                                   state.com[c], state.box[c], mc.kvecs,
                                   mc.kweights)
        ref = energy_components(mc.system, mc.params,
                                np.asarray(coords, np.float64),
                                np.asarray(state.com[c], np.float64),
                                float(state.box[c]))
        scale = sum(abs(v) for k, v in ref.items() if k != "total")
        for k, v in ref.items():
            tol = REL_TOL * (scale if k == "total" else max(abs(v), 1.0))
            assert abs(float(out[k]) - v) <= tol, (k, float(out[k]), v)
        assert abs(float(state.energy[c]) - ref["total"]) <= REL_TOL * scale


def test_flagship_f32_matches_reference(gpu_device):
    from metropolismontecarlo_tpu.run import _initial_state
    from metropolismontecarlo_tpu.utils.config import (
        build_params,
        build_system,
        load_config,
    )

    cfg = load_config(os.path.join(REPO, "configs", "spce_750.json"))
    cfg["run"]["n_chains"] = 64
    system, params = build_system(cfg, REPO), build_params(cfg)
    mc = MonteCarlo(system, params, dtype=jnp.float32)
    state = _initial_state(mc, cfg["run"], system, REPO)
    state = mc.quench(state, cfg["run"]["quench_steps"])
    state = mc.run_steps(state, 3, False)
    assert state.coords.devices() == {gpu_device}
    _check(mc, state)


def test_lj_f32_matches_reference(gpu_device):
    n = 256
    box = lj_box_for_density(n, 0.75)
    params = RunParams(temperature=1.0, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=box / 30)
    mc = MonteCarlo(lj_system(n), params, dtype=jnp.float32)
    state = mc.init_state(jax.random.PRNGKey(0), cubic_lattice(n, box),
                          box=box, n_chains=64)
    state = mc.run_steps(state, 20, False)
    assert state.coords.devices() == {gpu_device}
    _check(mc, state)
