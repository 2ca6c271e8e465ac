"""The trace/program reductions the smoke run reports (utils/trace.py),
on synthetic events and on a compiled CPU program."""

import jax
import jax.numpy as jnp
import pytest

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system
from metropolismontecarlo_tpu.utils import trace as tr


def test_busy_is_the_union_of_intervals():
    ev = [("s", "a", 0, 10), ("s", "b", 5, 10), ("s", "c", 30, 5),
          ("s", "d", 31, 1)]
    assert tr.busy_ns(ev) == 20
    assert tr.busy_ns([]) == 0


def test_summarize_ranks_ops_and_counts_steps():
    # two scan steps of [pair 8 ns, tiny 1 ns] with 1 ns gaps
    ev = [("s", "pair", 0, 8), ("s", "tiny", 9, 1),
          ("s", "pair", 11, 8), ("s", "tiny", 20, 1)]
    out = tr.summarize(ev, window_ns=25, n_steps=2)
    assert [o["name"] for o in out["top_ops"]] == ["pair", "tiny"]
    assert out["top_ops"][0]["count"] == 2
    assert out["busy_us"] == pytest.approx(18e-3)
    assert out["idle_share"] == pytest.approx(1 - 18 / 25)
    assert out["idle_share_in_span"] == pytest.approx(1 - 18 / 21)
    assert out["ops_per_step"] == 2.0
    assert out["top_per_step_op"]["name"] == "pair"
    assert out["top_per_step_op"]["us_per_step"] == pytest.approx(8e-3)


HLO = """HloModule m

%body.1 (p: (f32[4,3,128])) -> (f32[4,3,128]) {
  %c.1 = f32[4,3,128]{2,1,0} copy(f32[4,3,128]{2,1,0} %x)
  %d.2 = f32[4,3,128]{2,1,0} dynamic-update-slice(%c.1, %u, %i, %j, %k)
}

ENTRY %main.3 (a: f32[4,3,128]) -> f32[4,3,128] {
  %c.2 = f32[4,3,128]{2,1,0} copy(f32[4,3,128]{2,1,0} %a)
  %w = (f32[4,3,128]) while(%t), condition=%cond.1, body=%body.1
}
"""


def test_full_copies_counted_only_in_loop_bodies():
    n, where = tr.full_copies_in_loops(HLO, "f32[4,3,128]")
    assert n == 1 and where == {"body.1": 1}
    assert tr.full_copies_in_loops(HLO, "f32[8,3,128]")[0] == 0


def test_sweep_updates_coordinates_in_place_on_cpu():
    """The compiled sweep keeps the (C, 3, A_pad) coordinate update in
    place: no full-size copy inside the scan body."""
    system = spce_system(8)
    params = RunParams(temperature=300.0, r_cut=5.0, coulomb="ewald",
                       nk=3, ksq_max=9, dr_max=0.3, dphi_max=0.3)
    mc = MonteCarlo(system, params, dtype=jnp.float32, recompute_chunk=4)
    state = mc.init_state(jax.random.PRNGKey(0), cubic_lattice(8, 12.0),
                          box=12.0, n_chains=4)
    text = MonteCarlo.run_steps.lower(mc, state, 2, False).compile() \
        .as_text()
    assert "while" in text
    n, where = tr.full_copies_in_loops(
        text, f"f32[4,3,{system.n_atoms_padded}]")
    assert n == 0, where
