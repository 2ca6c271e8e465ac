"""Wolf reference-convention option + Ewald surface (tinfoil) term.

The reference computes Wolf energies in its own convention
(`Ewald/energy.jl:900-934`): plain erfc(kr)/r pair sum, a global
-(sum q)^2 erfc(k rc)/rc constant, and the standard self term — NOT the
pairwise-shifted Wolf et al. form this framework defaults to.
`RunParams.wolf_style="ref"` reproduces it number-for-number (validated
here against an independent NumPy brute force).

`RunParams.ewald_surface=True` adds the surface (dipole) term that
removes the tinfoil-boundary assumption — the reference's
written-but-disabled `TinfoilBoundary` (`Ewald/ewalds.jl:835-844`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import erfc as np_erfc

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.system import RunParams, System
from metropolismontecarlo_tpu.models.water import spce_system
from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR


def _charged_ions():
    """Four monatomic ions with a NON-neutral total charge, so the ref
    convention's (sum q)^2 constant is exercised."""
    q = np.array([1.0, 1.0, -1.0, 0.5])[:, None]
    return System(
        n_mol=4, atoms_per_mol=1,
        body=np.zeros((4, 1, 3)),
        masses=np.ones((4, 1)),
        charges=q,
        type_ids=np.zeros((4, 1), np.int32),
        eps_table=np.array([[1.0]]),
        sig_table=np.array([[1.0]]),
        name="ions",
    )


def _wolf_numpy(coords, mol_id, q, box, kappa, rc, style):
    """Independent brute force of both Wolf conventions."""
    e_pair = 0.0
    shift = np_erfc(kappa * rc) / rc
    n = len(q)
    for i in range(n):
        for j in range(i + 1, n):
            if mol_id[i] == mol_id[j]:
                continue
            d = coords[i] - coords[j]
            d -= box * np.round(d / box)
            r = np.linalg.norm(d)
            if r >= rc:
                continue
            if style == "pairwise":
                e_pair += q[i] * q[j] * (np_erfc(kappa * r) / r - shift)
            else:
                e_pair += q[i] * q[j] * np_erfc(kappa * r) / r
    e = e_pair
    if style == "ref":
        e -= np.sum(q) ** 2 * shift
    e -= (shift / 2.0 + kappa / np.sqrt(np.pi)) * np.sum(q * q)
    return COULOMB_FACTOR * e


@pytest.mark.parametrize("style", ["pairwise", "ref"])
def test_wolf_conventions_match_numpy(style):
    """Both Wolf flavors must match the brute force on a charged,
    non-neutral system (the (sum q)^2 constant is nonzero here)."""
    from metropolismontecarlo_tpu.models.energy import energy_breakdown_jit

    system = _charged_ions()
    box = 9.0
    params = RunParams(temperature=300.0, r_cut=4.0, cutoff_mode="site",
                       coulomb="wolf", wolf_style=style, use_lrc=False)
    mc = MonteCarlo(system, params, dtype=jnp.float64)
    com = np.array([[1.0, 1.2, 0.9], [3.1, 1.0, 1.1],
                    [1.1, 3.9, 2.2], [5.5, 5.0, 4.8]])
    state = mc.init_state(jax.random.PRNGKey(0), com, box=box, n_chains=1)
    A = system.n_atoms
    coords = np.asarray(state.coords[0, :, :A]).T
    out = energy_breakdown_jit(system, params, jnp.asarray(coords),
                               jnp.asarray(com), jnp.asarray(box))
    kappa = params.kappa_L / box
    e_np = _wolf_numpy(coords, np.arange(4), com[:, 0] * 0
                       + np.array([1.0, 1.0, -1.0, 0.5]), box, kappa,
                       params.qq_cut, style)
    e_repo = float(out["coul_real"] + out["coul_self"])
    np.testing.assert_allclose(e_repo, e_np, rtol=1e-10)


def test_wolf_ref_drift_and_distinct():
    """wolf_style='ref' keeps the drift invariant on the move path, and
    differs from the pairwise form by exactly the pairwise-shift sum
    (neutral system: the global constant vanishes)."""
    system = spce_system(8)
    base = dict(temperature=300.0, r_cut=5.0, cutoff_mode="site",
                coulomb="wolf", p_translate=0.5, dr_max=0.25, dphi_max=0.3)
    mc_ref = MonteCarlo(system, RunParams(wolf_style="ref", **base),
                        dtype=jnp.float64, recompute_chunk=4)
    mc_pw = MonteCarlo(system, RunParams(wolf_style="pairwise", **base),
                       dtype=jnp.float64, recompute_chunk=4)
    com0 = cubic_lattice(8, 12.0)
    s_ref = mc_ref.init_state(jax.random.PRNGKey(1), com0, box=12.0,
                              n_chains=4)
    s_pw = mc_pw.init_state(jax.random.PRNGKey(1), com0, box=12.0,
                            n_chains=4)
    # same config, different conventions -> different totals
    assert not np.allclose(np.asarray(s_ref.energy), np.asarray(s_pw.energy))
    s_ref, m = mc_ref.run_block(s_ref, 3, adjust=False)
    assert m["drift_max_rel"] < 1e-10, m["drift_max_rel"]


def test_ewald_surface_term():
    """Surface term: direct-formula agreement, per-molecule translation
    invariance (neutral molecules), and move-path drift."""
    from metropolismontecarlo_tpu.models.energy import energy_breakdown_jit
    from metropolismontecarlo_tpu.ops.ewald import make_kvectors

    system = spce_system(8)
    box = 12.0
    base = dict(temperature=300.0, r_cut=5.0, cutoff_mode="site",
                coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
                dr_max=0.25, dphi_max=0.3)
    p_on = RunParams(ewald_surface=True, **base)
    p_off = RunParams(**base)
    kv, kw = make_kvectors(3, 9)

    mc = MonteCarlo(system, p_on, dtype=jnp.float64,
                    recompute_chunk=4)
    com0 = cubic_lattice(8, box)
    state = mc.init_state(jax.random.PRNGKey(3), com0, box=box, n_chains=4)

    A = system.n_atoms
    coords = np.asarray(state.coords[0, :, :A]).T
    com = np.asarray(state.com[0])
    out_on = energy_breakdown_jit(system, p_on, jnp.asarray(coords),
                                  jnp.asarray(com), jnp.asarray(box), kv, kw)
    out_off = energy_breakdown_jit(system, p_off, jnp.asarray(coords),
                                   jnp.asarray(com), jnp.asarray(box), kv, kw)
    # direct formula: factor 2pi/(3V) |sum q r|^2 (neutral molecules make
    # the atom-position form equal the molecular-dipole form)
    q = np.asarray(system.flat(system.charges))
    m_vec = (q[:, None] * coords).sum(0)
    e_direct = COULOMB_FACTOR * 2 * np.pi / (3 * box**3) * (m_vec**2).sum()
    e_surf = float(out_on["coul_fourier"] - out_off["coul_fourier"])
    np.testing.assert_allclose(e_surf, e_direct, rtol=1e-8)
    assert e_surf > 0.0

    # translation invariance: move one molecule by an arbitrary vector
    shift = np.array([0.7, -1.3, 2.1])
    coords2 = coords.copy()
    coords2[:3] += shift                       # molecule 0's three sites
    com2 = com.copy()
    com2[0] += shift
    out2 = energy_breakdown_jit(system, p_on, jnp.asarray(coords2),
                                jnp.asarray(com2), jnp.asarray(box), kv, kw)
    out2_off = energy_breakdown_jit(system, p_off, jnp.asarray(coords2),
                                    jnp.asarray(com2), jnp.asarray(box),
                                    kv, kw)
    e_surf2 = float(out2["coul_fourier"] - out2_off["coul_fourier"])
    np.testing.assert_allclose(e_surf2, e_surf, rtol=1e-9)

    # move path carries the surface delta consistently (drift invariant)
    state, m = mc.run_block(state, 3, adjust=False)
    assert m["drift_max_rel"] < 1e-10, m["drift_max_rel"]
