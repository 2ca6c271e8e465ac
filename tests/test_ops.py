"""Unit tests for geometry/quaternion/LJ primitives, mirroring the
reference's artisanal inline tests (`Ewald/tests.jl`) as real assertions:
two-triangle LJ hand sum, COM, minimum-image mirror test, quaternion
algebra."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from metropolismontecarlo_tpu.ops import pbc, quaternions as quat
from metropolismontecarlo_tpu.ops.lj import lj_pair_terms, lj_masked_sum
from metropolismontecarlo_tpu.ops.pairs import pair_dist2


def test_min_image_basic():
    box = 10.0
    d = pbc.min_image(jnp.asarray([6.0, -6.0, 4.9]), box)
    np.testing.assert_allclose(d, [-4.0, 4.0, 4.9], atol=1e-12)


def test_wrap():
    box = 10.0
    r = pbc.wrap(jnp.asarray([-0.1, 10.2, 3.0]), box)
    np.testing.assert_allclose(r, [9.9, 0.2, 3.0], atol=1e-12)


def test_mirror_image_lj():
    """3 particles, one outside r_cut whose mirror image is inside —
    validates minimum-image (reference `Ewald/tests.jl:127-161`)."""
    box, r_cut = 10.0, 3.0
    r = jnp.asarray([[0.5, 0.0, 0.0], [2.0, 0.0, 0.0], [9.5, 0.0, 0.0]])
    d2, _ = pair_dist2(r, r, box)
    # particle 0 vs 2: direct distance 9.0, mirror distance 1.0
    assert float(d2[0, 2]) == pytest.approx(1.0)
    eps = jnp.ones((3, 3))
    sig = jnp.ones((3, 3))
    mask = (~jnp.eye(3, dtype=bool)) & (d2 < r_cut * r_cut)
    dr = jnp.zeros((3, 3, 3))
    d2s = jnp.where(mask, d2, 1.0)
    pot, _ = lj_pair_terms(d2s, eps, sig, r_cut)
    pot = jnp.sum(jnp.where(mask, pot, 0.0)) / 2.0

    def u(rr):
        return 4.0 * (rr**-12 - rr**-6)

    expected = u(1.5) + u(1.0) + u(2.5)  # pairs (0,1), (0,2 mirror), (1,2 mirror 7.5->2.5)
    assert float(pot) == pytest.approx(expected, rel=1e-12)


def test_two_triangle_hand_sum():
    """Two rigid triatomics at known separation vs an explicit 9-term sum
    (reference `Ewald/tests.jl:8-82`)."""
    box, r_cut = 100.0, 50.0
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    a = tri
    b = tri + np.array([3.0, 0.3, -0.2])
    coords = jnp.asarray(np.concatenate([a, b]))
    d2, dr = pair_dist2(coords, coords, box)
    mol_id = jnp.repeat(jnp.arange(2), 3)
    mask = mol_id[:, None] != mol_id[None, :]
    eps = jnp.ones((6, 6)) * 0.25
    sig = jnp.ones((6, 6)) * 1.1
    pot, _ = lj_masked_sum(d2, dr, dr, mask, eps, sig, r_cut, "none", True)
    hand = 0.0
    for i in range(3):
        for j in range(3):
            rr = np.linalg.norm(a[i] - b[j])
            hand += 4 * 0.25 * ((1.1 / rr) ** 12 - (1.1 / rr) ** 6)
    assert float(pot) / 2.0 == pytest.approx(hand, rel=1e-12)


def test_center_of_mass():
    pts = jnp.asarray([[1.0, 2.0, 3.0], [2.0, 3.0, 4.0], [0.0, 1.0, 2.0]])
    m = jnp.asarray([1.0, 1.0, 100.0])
    com = quat.center_of_mass(pts, m)
    np.testing.assert_allclose(
        com, (pts[0] + pts[1] + 100 * pts[2]) / 102.0, rtol=1e-12
    )


def test_quat_rotation_roundtrip():
    key = jax.random.PRNGKey(0)
    q = quat.random_quaternion(key, (64,), dtype=jnp.float64)
    # unit norm
    np.testing.assert_allclose(jnp.linalg.norm(q, axis=-1), 1.0, atol=1e-12)
    r = quat.quat_to_rot(q)
    # orthonormality: R R^T = I, det = +1
    rrt = jnp.einsum("...ij,...kj->...ik", r, r)
    np.testing.assert_allclose(rrt, np.broadcast_to(np.eye(3), (64, 3, 3)), atol=1e-12)
    np.testing.assert_allclose(jnp.linalg.det(r), 1.0, atol=1e-12)


def test_quat_mul_matches_rotation_composition():
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    qa = quat.random_quaternion(k1, (8,), dtype=jnp.float64)
    qb = quat.random_quaternion(k2, (8,), dtype=jnp.float64)
    r_ab = quat.quat_to_rot(quat.quat_mul(qa, qb))
    r_a = quat.quat_to_rot(qa)
    r_b = quat.quat_to_rot(qb)
    np.testing.assert_allclose(r_ab, jnp.einsum("...ij,...jk->...ik", r_a, r_b),
                               atol=1e-12)


def test_identity_quaternion():
    q = jnp.asarray([1.0, 0.0, 0.0, 0.0])
    np.testing.assert_allclose(quat.quat_to_rot(q), np.eye(3), atol=1e-15)


def test_rotation_about_z():
    th = 0.3
    q = jnp.asarray([np.cos(th / 2), 0.0, 0.0, np.sin(th / 2)])
    v = jnp.asarray([[1.0, 0.0, 0.0]])
    out = quat.rotate_vectors(q, v)
    np.testing.assert_allclose(out[0], [np.cos(th), np.sin(th), 0.0], atol=1e-12)


def test_random_rotate_small_angle():
    key = jax.random.PRNGKey(2)
    q0 = quat.random_quaternion(key, (16,), dtype=jnp.float64)
    q1 = quat.random_rotate_quaternion(jax.random.PRNGKey(3), q0, 1e-4)
    # stays unit and close to original
    np.testing.assert_allclose(jnp.linalg.norm(q1, axis=-1), 1.0, atol=1e-12)
    dot = jnp.abs(jnp.sum(q0 * q1, axis=-1))
    assert float(jnp.min(dot)) > 1.0 - 1e-8


def test_uniform_quaternion_statistics():
    """Mean of each component ~ 0 and covariance ~ I/4 for uniform S^3."""
    q = quat.random_quaternion(jax.random.PRNGKey(4), (20000,), dtype=jnp.float64)
    assert float(jnp.max(jnp.abs(jnp.mean(q, axis=0)))) < 0.02
    cov = q.T @ q / q.shape[0]
    np.testing.assert_allclose(cov, np.eye(4) * 0.25, atol=0.02)


def test_chunked_vmap_divisor_fallback():
    """chunked_vmap must give identical results for any chunk size, and
    degrade non-divisible chain counts to the largest divisor (not 1)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from metropolismontecarlo_tpu.utils.chunking import chunked_vmap

    x = jnp.arange(30.0).reshape(6, 5)
    fn = lambda row: (row * row).sum()  # noqa: E731
    want = np.asarray(jax.vmap(fn)(x))
    for chunk in (1, 2, 3, 4, 5, 6, 7, 64):
        got = np.asarray(chunked_vmap(fn, chunk, x))
        assert np.array_equal(got, want), chunk


def test_dense_recompute_has_no_gathers():
    """Canary for the gather cliff: a traced (A, A) table gather inside
    the chunked recompute scan is not hoisted and is paid again at every
    step.  Pair tables must be numpy-expanded constants and mask
    expansions one-hot matmuls, so the compiled dense path contains NO
    gather ops at all."""
    import re

    import jax
    import jax.numpy as jnp

    from metropolismontecarlo_tpu.models.energy import energy_breakdown
    from metropolismontecarlo_tpu.models.system import RunParams
    from metropolismontecarlo_tpu.models.water import spce_system
    from metropolismontecarlo_tpu.ops.ewald import make_kvectors

    system = spce_system(64)
    params = RunParams(temperature=300.0, r_cut=6.0, cutoff_mode="site",
                       coulomb="ewald", nk=4, ksq_max=16)
    kv, kw = make_kvectors(4, 16)
    A = system.n_atoms
    f = jax.jit(lambda c, m, b:
                energy_breakdown(system, params, c, m, b, kv, kw)["total"])
    txt = f.lower(jnp.zeros((A, 3)), jnp.zeros((64, 3)),
                  jnp.asarray(20.0, jnp.float32)).compile().as_text()
    gathers = [ln.strip()[:120] for ln in txt.splitlines()
               if re.search(r"\bgather\(", ln)]
    assert not gathers, gathers


def test_structure_factor_recurrence_matches_direct():
    """The eik-recurrence structure factor (ops/ewald.structure_factor,
    the reference's eikx/eiky/eikz tables via static one-hot matmul
    selection) must agree with the direct cos/sin path to roundoff —
    f64 here (~1e-13 measured; f32 agrees to ~1.4e-6 relative)."""
    import jax
    import jax.numpy as jnp

    from metropolismontecarlo_tpu.ops.ewald import (
        make_kvectors,
        structure_factor,
        structure_factor_direct,
    )

    kv, _ = make_kvectors(6, 36)
    assert len(kv) >= 16
    coords = jax.random.uniform(jax.random.PRNGKey(0), (3, 120, 3),
                                jnp.float64) * 17.0
    q = jax.random.normal(jax.random.PRNGKey(1), (120,), jnp.float64)
    box = jnp.float64(17.0)
    a = structure_factor(coords, q, jnp.asarray(kv), box)
    b = structure_factor_direct(coords, q, jnp.asarray(kv), box)
    assert a.shape == b.shape == (3, len(kv), 2)
    assert float(jnp.max(jnp.abs(a - b))) < 1e-10
    # the small-A pose-row fallback still goes through (same answer)
    a4 = structure_factor(coords[:, :4], q[:4], jnp.asarray(kv), box)
    b4 = structure_factor_direct(coords[:, :4], q[:4], jnp.asarray(kv),
                                 box)
    assert float(jnp.max(jnp.abs(a4 - b4))) == 0.0


def test_activity_slot_helpers():
    """utils/activity.py one-hot where-select updates == the scatter
    semantics they replace (the bool-scatter hazard fix must be a pure
    reformulation)."""
    import jax.numpy as jnp
    import numpy as np

    from metropolismontecarlo_tpu.utils.activity import (
        clear_slot,
        clear_slot2,
        set_slot,
        set_slot2,
    )

    rng = np.random.default_rng(3)
    for _ in range(20):
        a = jnp.asarray(rng.random(17) < 0.4)
        i = int(rng.integers(17))
        on = bool(rng.random() < 0.5)
        ref = np.asarray(a).copy()
        ref[i] = on | ref[i]
        assert np.array_equal(np.asarray(set_slot(a, i, jnp.asarray(on))),
                              ref)
        off = bool(rng.random() < 0.5)
        ref2 = np.asarray(a).copy()
        ref2[i] = ref2[i] & ~off
        assert np.array_equal(
            np.asarray(clear_slot(a, i, jnp.asarray(off))), ref2)
    a2 = jnp.asarray(rng.random((2, 9)) < 0.5)
    for b in (0, 1):
        for i in (0, 4, 8):
            r = np.asarray(a2).copy()
            r[b, i] = True
            assert np.array_equal(
                np.asarray(set_slot2(a2, b, i, jnp.asarray(True))), r)
            r2 = np.asarray(a2).copy()
            r2[b, i] = False
            assert np.array_equal(
                np.asarray(clear_slot2(a2, b, i, jnp.asarray(True))), r2)


def test_structure_factor_fallback_paths(monkeypatch):
    """The recurrence path must ROUTE AROUND itself in the three cases
    where it cannot or should not run, and each fallback must still be
    the correct answer:

    * extreme K (ngrid * K > 4M): the baked selection one-hot would be
      tens-to-hundreds of MB of HLO constant (at tuned cap-256 Gibbs
      shapes) — must call `structure_factor_direct`;
    * traced kvecs (e.g. `energy_breakdown_jit` passes them as jit
      operands): the recurrence indexes tables at trace time, so a
      tracer must fall back;
    * small A (pose rows): tables cost more than they save.
    """
    from metropolismontecarlo_tpu.ops import ewald

    calls = []
    real_direct = ewald.structure_factor_direct

    def spy(coords, charges, kvecs, box):
        calls.append(coords.shape)
        return real_direct(coords, charges, kvecs, box)

    monkeypatch.setattr(ewald, "structure_factor_direct", spy)

    # -- extreme-K guard: nk=16, ksq<=256 -> K ~ 8.5k, ngrid ~ 18.5k,
    # product ~ 1.6e8 >> 4M --
    kv_big, _ = ewald.make_kvectors(16, 256)
    nx = int(kv_big[:, 0].max())
    ny = int(np.abs(kv_big[:, 1]).max())
    nz = int(np.abs(kv_big[:, 2]).max())
    assert (nx + 1) * (2 * ny + 1) * (2 * nz + 1) * len(kv_big) \
        > 4_000_000
    box = jnp.float64(17.0)
    coords = jax.random.uniform(jax.random.PRNGKey(7), (40, 3),
                                jnp.float64) * 17.0
    q = jax.random.normal(jax.random.PRNGKey(8), (40,), jnp.float64)
    out = ewald.structure_factor(coords, q, jnp.asarray(kv_big), box)
    assert len(calls) == 1        # guard routed to the direct path
    assert out.shape == (len(kv_big), 2)
    assert bool(jnp.all(jnp.isfinite(out)))

    # -- traced kvecs: a jit operand cannot be np.asarray'd at trace
    # time -> TracerArrayConversionError branch --
    calls.clear()
    kv, _ = ewald.make_kvectors(6, 36)

    @jax.jit
    def through_jit(c, ch, kvecs, b):
        return ewald.structure_factor(c, ch, kvecs, b)

    a = through_jit(coords, q, jnp.asarray(kv), box)
    assert len(calls) == 1        # traced-kvecs fallback taken
    b_ref = real_direct(coords, q, jnp.asarray(kv), box)
    assert float(jnp.max(jnp.abs(a - b_ref))) < 1e-10

    # -- small-A pose row --
    calls.clear()
    a4 = ewald.structure_factor(coords[:4], q[:4], jnp.asarray(kv), box)
    assert len(calls) == 1
    assert float(jnp.max(jnp.abs(
        a4 - real_direct(coords[:4], q[:4], jnp.asarray(kv), box)))) == 0.0
