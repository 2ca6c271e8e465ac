"""TIP4P/2005 4-site water: geometry, explicit-sum energy cross-check,
kernel parity at P=4, and the drift invariant with a massless charged
virtual site."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo
from metropolismontecarlo_tpu.models.system import RunParams
from metropolismontecarlo_tpu.models.water import (
    MASS_H,
    MASS_O,
    TIP4P2005_EPS_OO,
    TIP4P2005_Q_H,
    TIP4P2005_Q_M,
    TIP4P2005_R_OH,
    TIP4P2005_R_OM,
    TIP4P2005_SIGMA_OO,
    TIP4P2005_THETA,
    tip4p2005_system,
)
from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR


def test_tip4p_body_frame_geometry():
    """r_OH, HOH angle, M on the bisector at r_OM, mass-weighted COM at
    the origin (the massless M site carries zero COM weight)."""
    b = np.asarray(tip4p2005_system(1).body)[0]
    o, h1, h2, m = b
    assert np.linalg.norm(h1 - o) == pytest.approx(TIP4P2005_R_OH, abs=1e-12)
    assert np.linalg.norm(h2 - o) == pytest.approx(TIP4P2005_R_OH, abs=1e-12)
    cosang = np.dot(h1 - o, h2 - o) / TIP4P2005_R_OH**2
    assert np.degrees(np.arccos(cosang)) == pytest.approx(TIP4P2005_THETA,
                                                          abs=1e-9)
    assert np.linalg.norm(m - o) == pytest.approx(TIP4P2005_R_OM, abs=1e-12)
    bis = (h1 - o) + (h2 - o)
    assert np.dot(m - o, bis) == pytest.approx(
        np.linalg.norm(m - o) * np.linalg.norm(bis), rel=1e-12)  # collinear
    w = np.array([MASS_O, MASS_H, MASS_H, 0.0])
    com = (b * w[:, None]).sum(0) / w.sum()
    np.testing.assert_allclose(com, 0.0, atol=1e-12)
    q = np.asarray(tip4p2005_system(1).charges)[0]
    assert q.sum() == pytest.approx(0.0, abs=1e-12)
    assert q[0] == 0.0 and q[3] == TIP4P2005_Q_M


def test_tip4p_dimer_energy_explicit_sum():
    """Two molecules at 3.2 A separation: the production energy model
    must equal an independent NumPy sum over the 16 site pairs (O-O LJ
    + bare Coulomb on H/M sites)."""
    from metropolismontecarlo_tpu.models.energy import energy_breakdown
    from metropolismontecarlo_tpu.ops.quaternions import rotate_vectors

    sys2 = tip4p2005_system(2)
    params = RunParams(strict_min_image=False, temperature=300.0,
                       r_cut=12.0, cutoff_mode="com", coulomb="bare",
                       use_lrc=False)
    box = 40.0
    body = jnp.asarray(sys2.body[0])
    com = jnp.asarray([[10.0, 10.0, 10.0], [13.2, 10.0, 10.0]])
    quat = jnp.asarray([[1.0, 0.0, 0.0, 0.0],
                        [0.937, 0.23, -0.21, 0.15]])
    quat = quat / jnp.linalg.norm(quat, axis=-1, keepdims=True)
    ra = com[:, None, :] + jax.vmap(rotate_vectors, (0, None))(quat, body)
    coords = ra.reshape(8, 3)
    out = energy_breakdown(sys2, params, coords, com, jnp.asarray(box))

    r = np.asarray(ra, np.float64)
    q = np.asarray(sys2.charges, np.float64)
    e_ref = 0.0
    for a in range(4):
        for b in range(4):
            d = np.linalg.norm(r[0, a] - r[1, b])
            if a == 0 and b == 0:
                s6 = (TIP4P2005_SIGMA_OO / d) ** 6
                e_ref += 4.0 * TIP4P2005_EPS_OO * (s6 * s6 - s6)
            e_ref += COULOMB_FACTOR * q[0, a] * q[1, b] / d
    assert float(out["total"]) == pytest.approx(e_ref, rel=1e-10)


def test_tip4p_nvt_drift_and_rotation():
    """f64 NVT run: carried energy vs recompute through translations AND
    rotations (rotating a molecule moves its charged M site)."""
    system = tip4p2005_system(27)
    params = RunParams(strict_min_image=False, temperature=300.0,
                       r_cut=6.0, cutoff_mode="site", coulomb="ewald",
                       p_translate=0.5, dr_max=0.3, dphi_max=0.4)
    mc = MonteCarlo(system, params, dtype=jnp.float64, recompute_chunk=8)
    state = mc.init_state(jax.random.PRNGKey(2), cubic_lattice(27, 14.0),
                          box=14.0, n_chains=8)
    state, stats = mc.run_block(state, 20, adjust=False)
    assert stats["drift_max_rel"] < 1e-10, stats
    assert stats["acc_rot"] > 0.0   # rotations accepted


def test_tip4p_variant_parameters():
    """TIP4P-Ew and TIP4P/Ice share the TIP4P topology with their own
    published parameters; all three variants are neutral, M is massless,
    and the drift invariant holds for each through moves."""
    from metropolismontecarlo_tpu.models.water import (
        tip4pew_system,
        tip4pice_system,
    )

    for builder, q_h, r_om in ((tip4pew_system, 0.52422, 0.125),
                               (tip4pice_system, 0.5897, 0.1577)):
        s = builder(8)
        q = np.asarray(s.charges)[0]
        assert q.sum() == pytest.approx(0.0, abs=1e-12)
        assert q[1] == q_h and q[3] == -2.0 * q_h
        b = np.asarray(s.body)[0]
        assert np.linalg.norm(b[3] - b[0]) == pytest.approx(r_om,
                                                            abs=1e-12)
        assert np.asarray(s.masses)[0, 3] == 0.0

        params = RunParams(strict_min_image=False, temperature=300.0,
                           r_cut=6.0, cutoff_mode="site", coulomb="ewald",
                           p_translate=0.5, dr_max=0.3, dphi_max=0.4)
        mc = MonteCarlo(builder(8), params, dtype=jnp.float64,
                        recompute_chunk=4)
        state = mc.init_state(jax.random.PRNGKey(5),
                              cubic_lattice(8, 13.0), box=13.0,
                              n_chains=4)
        state, stats = mc.run_block(state, 10, adjust=False)
        assert stats["drift_max_rel"] < 1e-10, (s.name, stats)
