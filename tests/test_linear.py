"""TraPPE rigid linear molecules (CO2, N2): geometry, LB mixed-type
tables, explicit dimer cross-check, collinear Kabsch recovery, kernel
parity, and the drift invariant through rotations of a rank-2 body."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.linear import (
    CO2_EPS_C,
    CO2_EPS_O,
    CO2_Q_C,
    CO2_Q_O,
    CO2_R_CO,
    CO2_SIG_C,
    CO2_SIG_O,
    N2_Q_M,
    N2_Q_N,
    N2_R_NN,
    co2_system,
    n2_system,
)
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR


def test_co2_geometry_and_tables():
    s = co2_system(2)
    b = np.asarray(s.body)[0]
    c, o1, o2 = b
    assert np.linalg.norm(o1 - c) == pytest.approx(CO2_R_CO, abs=1e-12)
    assert np.linalg.norm(o2 - c) == pytest.approx(CO2_R_CO, abs=1e-12)
    # collinear and COM (= carbon) at the origin
    assert np.linalg.norm(np.cross(o1 - c, o2 - c)) == pytest.approx(0.0,
                                                                     abs=1e-12)
    np.testing.assert_allclose(c, 0.0, atol=1e-12)
    q = np.asarray(s.charges)[0]
    assert q.sum() == pytest.approx(0.0, abs=1e-12)
    # Lorentz-Berthelot cross terms
    eps = np.asarray(s.eps_table)
    sig = np.asarray(s.sig_table)
    assert eps[0, 1] == pytest.approx(np.sqrt(CO2_EPS_C * CO2_EPS_O))
    assert sig[0, 1] == pytest.approx(0.5 * (CO2_SIG_C + CO2_SIG_O))
    assert eps[2, 2] == 0.0 and sig[2, 2] == 1.0   # pad type is inert


def test_n2_geometry_neutral_massless():
    s = n2_system(2)
    b = np.asarray(s.body)[0]
    assert np.linalg.norm(b[0] - b[1]) == pytest.approx(N2_R_NN, abs=1e-12)
    np.testing.assert_allclose(b[2], 0.0, atol=1e-12)  # M at the COM
    q = np.asarray(s.charges)[0]
    assert q.sum() == pytest.approx(0.0, abs=1e-12)
    assert q[2] == N2_Q_M and q[0] == N2_Q_N
    m = np.asarray(s.masses)[0]
    assert m[2] == 0.0 and m[0] > 0.0
    assert np.asarray(s.eps_table)[1, 1] == 0.0    # charge-only site


def test_co2_dimer_energy_explicit_sum():
    """Two CO2 molecules at 4 A separation: the production energy model
    must equal an independent NumPy sum over the 9 site pairs with the
    correct per-type-pair LB epsilon/sigma plus bare Coulomb."""
    from metropolismontecarlo_tpu.models.energy import energy_breakdown
    from metropolismontecarlo_tpu.ops.quaternions import rotate_vectors

    sys2 = co2_system(2)
    params = RunParams(strict_min_image=False, temperature=300.0,
                       r_cut=15.0, cutoff_mode="com", coulomb="bare",
                       use_lrc=False)
    box = 50.0
    body = jnp.asarray(sys2.body[0])
    com = jnp.asarray([[20.0, 20.0, 20.0], [24.0, 20.5, 19.0]])
    quat = jnp.asarray([[0.88, 0.31, -0.27, 0.22],
                        [0.60, -0.44, 0.58, 0.33]])
    quat = quat / jnp.linalg.norm(quat, axis=-1, keepdims=True)
    ra = com[:, None, :] + jax.vmap(rotate_vectors, (0, None))(quat, body)
    out = energy_breakdown(sys2, params, ra.reshape(6, 3), com,
                           jnp.asarray(box))

    r = np.asarray(ra, np.float64)
    q = np.asarray(sys2.charges, np.float64)
    eps_t = np.asarray(sys2.eps_table)
    sig_t = np.asarray(sys2.sig_table)
    tid = np.asarray(sys2.type_ids)[0]
    e_ref = 0.0
    for a in range(3):
        for b in range(3):
            d = np.linalg.norm(r[0, a] - r[1, b])
            eps, sig = eps_t[tid[a], tid[b]], sig_t[tid[a], tid[b]]
            s6 = (sig / d) ** 6
            e_ref += 4.0 * eps * (s6 * s6 - s6)
            e_ref += COULOMB_FACTOR * q[0, a] * q[1, b] / d
    assert float(out["total"]) == pytest.approx(e_ref, rel=1e-10)


def test_linear_kabsch_roundtrip():
    """init_from_coords on a COLLINEAR body: the rank-1 Kabsch fit must
    reproduce the input atom coordinates exactly (axis recovered; the
    unobservable spin about the axis does not move any site)."""
    from metropolismontecarlo_tpu.ops.quaternions import (
        random_quaternion,
        rotate_vectors,
    )

    for system in (co2_system(8), n2_system(8)):
        params = RunParams(strict_min_image=False, temperature=300.0,
                           r_cut=5.0, cutoff_mode="site", coulomb="ewald")
        mc = MonteCarlo(system, params, dtype=jnp.float64)
        com = jnp.asarray(cubic_lattice(8, 12.0), jnp.float64)
        quat = jax.vmap(random_quaternion)(
            jax.random.split(jax.random.PRNGKey(7), 8))
        body = jnp.asarray(system.body, jnp.float64)
        coords = (com[:, None, :]
                  + jax.vmap(rotate_vectors)(quat, body)).reshape(-1, 3)
        state = mc.init_from_coords(jax.random.PRNGKey(0), coords, com,
                                    box=12.0, n_chains=2)
        rebuilt = np.asarray(state.coords)[0].T[: system.n_atoms]
        np.testing.assert_allclose(rebuilt, np.asarray(coords),
                                   atol=1e-10, err_msg=system.name)


def test_linear_nvt_drift_and_rotation():
    """f64 NVT runs of both species: carried energy vs recompute through
    translations and rotations of the linear bodies (N2 also exercises a
    rotating massless charge site)."""
    for system, box in ((co2_system(27), 16.0), (n2_system(27), 14.0)):
        params = RunParams(strict_min_image=False, temperature=250.0,
                           r_cut=6.0, cutoff_mode="site", coulomb="ewald",
                           p_translate=0.5, dr_max=0.3, dphi_max=0.4)
        mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=8)
        state = mc.init_state(jax.random.PRNGKey(2),
                              cubic_lattice(27, box), box=box, n_chains=8)
        state, stats = mc.run_block(state, 20, adjust=False)
        assert stats["drift_max_rel"] < 1e-10, (system.name, stats)
        assert stats["acc_rot"] > 0.0
