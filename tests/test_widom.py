"""Widom test-particle insertion (mc/widom.py): the insertion energy must
EXACTLY equal the full-recompute energy difference between the (M+1)- and
M-molecule systems at the same pose — across coulomb styles, cutoff
modes, and the monatomic P=1 path.  This pins every term the sampled
model contains (LJ, LRC increment, real/recip/self/intra, wolf
constants) to the independently-implemented models/energy.py route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.mc.widom import make_widom_fn, mu_excess
from metropolismontecarlo_tpu.models.energy import energy_breakdown
from metropolismontecarlo_tpu.models.monatomic import lj_system
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import spce_system
from metropolismontecarlo_tpu.ops.quaternions import (
    random_quaternion,
    rotate_vectors,
)

F64 = jnp.float64


def _water_pose(m, box, seed):
    """Exact rigid configuration: com + R(q) body for every molecule."""
    system = spce_system(m)
    com = jnp.asarray(cubic_lattice(m, box), F64)
    quat = random_quaternion(jax.random.PRNGKey(seed), (m,), F64)
    body = jnp.asarray(np.asarray(system.body), F64)
    coords = (com[:, None, :] + rotate_vectors(quat, body)).reshape(-1, 3)
    return system, com, quat, coords


def _du_vs_recompute(params, ghost_com, seed=7, box=12.0, m=8):
    sys8, com8, quat8, coords8 = _water_pose(m, box, seed)
    sys9 = spce_system(m + 1)
    quat_t = random_quaternion(jax.random.PRNGKey(seed + 100), (), F64)
    com_t = jnp.asarray(ghost_com, F64)
    body_t = jnp.asarray(np.asarray(sys9.body)[m], F64)
    ra_t = com_t[None, :] + rotate_vectors(quat_t, body_t)

    mc = MonteCarlo(sys8, params, dtype=F64, recompute_chunk=1)
    state = mc.init_from_coords(jax.random.PRNGKey(0), coords8, com8,
                                box=box, n_chains=1)
    widom_du, _ = make_widom_fn(sys8, params, mc.kvecs, mc.kweights,
                                dtype=F64, chunk=1)
    du, ovr = widom_du(state, com_t[None, None, :], quat_t[None, None, :])

    # independent route: full recompute of the augmented system; use the
    # STATE's rebuilt coords so both routes see the identical 8-mol pose
    coords8_state = state.coords[0, :, : sys8.n_atoms].T
    e8 = energy_breakdown(sys8, params, coords8_state, com8,
                          jnp.asarray(box, F64), mc.kvecs, mc.kweights)
    coords9 = jnp.concatenate([coords8_state, ra_t], axis=0)
    com9 = jnp.concatenate([com8, com_t[None, :]], axis=0)
    e9 = energy_breakdown(sys9, params, coords9, com9,
                          jnp.asarray(box, F64), mc.kvecs, mc.kweights)
    expect = np.float64(e9["total"]) - np.float64(e8["total"])
    return np.asarray(du)[0, 0], expect, np.asarray(ovr)[0, 0]


STYLES = [
    dict(coulomb="ewald"),
    dict(coulomb="ewald", qq_r_cut=4.0),
    dict(coulomb="ewald", ewald_surface=True),
    dict(coulomb="wolf"),
    dict(coulomb="wolf", wolf_style="ref"),
    dict(coulomb="bare"),
    dict(coulomb="none"),
    dict(coulomb="ewald", cutoff_mode="com"),
    dict(coulomb="none", cutoff_mode="first", use_lrc=False),
]


@pytest.mark.parametrize("kw", STYLES, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
def test_widom_du_matches_full_recompute(kw):
    params = RunParams(temperature=300.0, r_cut=5.0, nk=3, ksq_max=9, **kw)
    du, expect, ovr = _du_vs_recompute(params, [4.61, 4.37, 4.52])
    assert not ovr
    np.testing.assert_allclose(du, expect, rtol=1e-9, atol=1e-7)


def test_widom_du_monatomic_matches_numpy():
    """P=1 path vs an independent NumPy evaluation on a grid of poses."""
    n, box, rc = 27, 9.0, 2.5
    system = lj_system(n)
    params = RunParams(strict_min_image=False, temperature=1.5, r_cut=rc,
                       coulomb="none", p_translate=1.0, use_lrc=False)
    com = np.asarray(cubic_lattice(n, box), np.float64)
    mc = MonteCarlo(system, params, dtype=F64,
                    recompute_chunk=1)
    state = mc.init_from_coords(jax.random.PRNGKey(0), com, com, box=box,
                                n_chains=1)
    g = np.linspace(0.21, box - 0.29, 4)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    quat = np.tile([1.0, 0, 0, 0], (len(pts), 1))
    widom_du, _ = make_widom_fn(system, params, None, None, dtype=F64,
                                chunk=1)
    du, _ = widom_du(state, jnp.asarray(pts)[None], jnp.asarray(quat)[None])

    dr = pts[:, None, :] - com[None, :, :]
    dr -= box * np.round(dr / box)
    d2 = np.maximum((dr**2).sum(-1), 1e-4)
    s6 = (1.0 / d2) ** 3
    e = np.where(d2 < rc * rc, 4.0 * (s6 * s6 - s6), 0.0).sum(-1)
    np.testing.assert_allclose(np.asarray(du)[0], e, rtol=1e-12, atol=1e-12)


def test_widom_sampler_and_mu_shapes():
    """The random sampler: finite factors in [0, inf), deterministic under
    the same key, and the dilute limit is near-ideal (factor ~ 1)."""
    n, box = 8, 40.0  # 8 atoms in a 40^3 box: effectively ideal gas
    system = lj_system(n)
    params = RunParams(strict_min_image=False, temperature=2.0, r_cut=3.0,
                       coulomb="none", p_translate=1.0, use_lrc=False)
    com = np.asarray(cubic_lattice(n, box), np.float64)
    mc = MonteCarlo(system, params, dtype=F64,
                    recompute_chunk=2)
    state = mc.init_from_coords(jax.random.PRNGKey(0), com, com, box=box,
                                n_chains=4)
    out = mc.widom(state, jax.random.PRNGKey(5), n_insertions=256)
    b = np.asarray(out["boltzmann_mean"])
    assert b.shape == (4,)
    assert np.all(np.isfinite(b)) and np.all(b > 0.9) and np.all(b < 1.1)
    out2 = mc.widom(state, jax.random.PRNGKey(5), n_insertions=256)
    np.testing.assert_array_equal(b, np.asarray(out2["boltzmann_mean"]))
    mu = np.asarray(mu_excess(jnp.asarray(b), state.temp))
    assert np.all(np.abs(mu) < 0.5)


def test_widom_overlap_vetoed():
    """A ghost dropped onto an existing molecule's oxygen must either
    trip the overlap veto or return a hugely positive energy — never a
    Boltzmann factor > 1 blow-up."""
    params = RunParams(temperature=300.0, r_cut=5.0, nk=3, ksq_max=9,
                       coulomb="ewald")
    sys8, com8, quat8, coords8 = _water_pose(8, 12.0, 3)
    mc = MonteCarlo(sys8, params, dtype=F64, recompute_chunk=1)
    state = mc.init_from_coords(jax.random.PRNGKey(0), coords8, com8,
                                box=12.0, n_chains=1)
    widom_du, _ = make_widom_fn(sys8, params, mc.kvecs, mc.kweights,
                                dtype=F64, chunk=1)
    com_t = com8[3] + jnp.asarray([0.05, 0.0, 0.0], F64)
    quat_t = random_quaternion(jax.random.PRNGKey(9), (), F64)
    du, ovr = widom_du(state, com_t[None, None, :], quat_t[None, None, :])
    assert bool(np.asarray(ovr)[0, 0]) or float(np.asarray(du)[0, 0]) > 1e4


def test_widom_low_density_virial_limit():
    """Physics check of the SAMPLER (not just dU): for a dilute LJ gas,
    beta mu_ex = 2 B2(T) rho + O(rho^2), with B2 from independent
    numerical quadrature of the truncated potential actually sampled
    (B2 = -2 pi int (e^{-beta u(r)} - 1) r^2 dr, u = 0 beyond r_cut)."""
    from scipy.integrate import quad

    n, t, rc = 16, 2.0, 3.0
    box = 20.0                      # rho = 0.002: virial regime
    rho = n / box**3
    system = lj_system(n)
    params = RunParams(strict_min_image=False, temperature=t, r_cut=rc,
                       coulomb="none", p_translate=1.0, dr_max=1.0,
                       use_lrc=False)
    mc = MonteCarlo(system, params, dtype=F64,
                    recompute_chunk=8)
    com = np.asarray(cubic_lattice(n, box), np.float64)
    state = mc.init_from_coords(jax.random.PRNGKey(0), com, com, box=box,
                                n_chains=32)
    state = mc.run_steps(state, 40, False)  # decorrelate the gas

    bs = []
    for i in range(6):
        state = mc.run_steps(state, 10, False)
        out = mc.widom(state, jax.random.PRNGKey(50 + i), n_insertions=512)
        bs.append(np.asarray(out["boltzmann_mean"]))
    b_mean = float(np.mean(bs))

    def integrand(r):
        u = 4.0 * (r**-12 - r**-6) if r < rc else 0.0
        return (np.exp(-u / t) - 1.0) * r * r

    b2 = -2.0 * np.pi * quad(integrand, 1e-3, rc, limit=200)[0]
    beta_mu = -np.log(b_mean)
    expect = 2.0 * b2 * rho
    # O(rho^2) corrections and sampling noise: 15% of the (small) signal
    assert abs(beta_mu - expect) < max(0.15 * abs(expect), 5e-4), (
        beta_mu, expect)
