"""Quaternion kit for rigid-body Monte Carlo (jit/vmap friendly).

Capability parity with reference `Ewald/quaternions.jl` (q_to_a, quatmul,
random_quaternion, random_rotate_quaternion, random_vector) and
`Ewald/structs.jl:217-245` (body-fixed frames), re-designed for XLA:

* no rejection sampling — uniform unit quaternions via the Shoemake/
  sub-group method and unit vectors via normalized Gaussians, so every
  sampler is fixed-shape and branch-free;
* the rotation matrix uses the standard (Allen & Tildesley eq. 3.40)
  formulas.  NOTE: the reference's live `q_to_a` has a transcribed-term bug
  (`Ewald/quaternions.jl:42-44` vs the correct commented rows `:27-29`);
  we implement the correct matrix and validate against NIST golden energies
  rather than the reference binary.

Convention: q = (w, x, y, z), scalar first, Hamilton product.
All functions operate on trailing axis -1 of shape (..., 4) / (..., 3)
arrays and broadcast over leading (chain, molecule, ...) axes.
"""

import jax
import jax.numpy as jnp


def normalize(q, axis=-1, eps=0.0):
    n = jnp.linalg.norm(q, axis=axis, keepdims=True)
    return q / (n + eps)


def quat_to_rot(q):
    """Body-frame -> lab-frame rotation matrix.

    q: (..., 4) unit quaternion (w, x, y, z).
    Returns (..., 3, 3) with lab = R @ body.

    This is the transpose of A&T's space->body matrix `a` (reference
    `Ewald/quaternions.jl:11-50` computes `a` and applies it as a^T via
    `MATMUL`, `Ewald/auxillary.jl:153-159`).
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r00 = ww + xx - yy - zz
    r11 = ww - xx + yy - zz
    r22 = ww - xx - yy + zz
    r01 = 2.0 * (xy - wz)
    r02 = 2.0 * (xz + wy)
    r10 = 2.0 * (xy + wz)
    r12 = 2.0 * (yz - wx)
    r20 = 2.0 * (xz - wy)
    r21 = 2.0 * (yz + wx)
    row0 = jnp.stack([r00, r01, r02], axis=-1)
    row1 = jnp.stack([r10, r11, r12], axis=-1)
    row2 = jnp.stack([r20, r21, r22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotate_vectors(q, v):
    """Rotate body-frame vectors v (..., P, 3) by quaternions q (..., 4).

    HIGHEST precision: a reduced-precision f32 matmul (bf16 or TF32
    passes) would distort rigid geometry by ~0.4% per rebuild."""
    rot = quat_to_rot(q)
    return jnp.einsum("...ij,...pj->...pi", rot, v,
                      precision=jax.lax.Precision.HIGHEST)


def quat_mul(a, b):
    """Hamilton product a * b, both (..., 4). Reference: quatmul `:76-91`."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def random_unit_vector(key, shape=(), dtype=jnp.float32):
    """Uniform random unit 3-vectors, shape (..., 3).

    Branch-free replacement for the reference's rejection sampler
    (`Ewald/quaternions.jl:52-74`): normalized standard Gaussians.
    """
    g = jax.random.normal(key, shape + (3,), dtype=dtype)
    return normalize(g)


def random_quaternion(key, shape=(), dtype=jnp.float32):
    """Uniform random unit quaternions on S^3, shape (..., 4).

    Shoemake's method (fixed-shape), replacing the reference's Marsaglia
    rejection sampler (`Ewald/quaternions.jl:122-156`).
    """
    u = jax.random.uniform(key, shape + (3,), dtype=dtype)
    u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2]
    a, b = jnp.sqrt(1.0 - u1), jnp.sqrt(u1)
    t2, t3 = 2.0 * jnp.pi * u2, 2.0 * jnp.pi * u3
    return jnp.stack(
        [a * jnp.sin(t2), a * jnp.cos(t2), b * jnp.sin(t3), b * jnp.cos(t3)],
        axis=-1,
    )


def random_rotate_quaternion(key, q, dphi_max):
    """Perturb unit quaternion(s) by a rotation of uniform random angle in
    [-dphi_max, dphi_max] about a uniform random axis.

    Symmetric proposal (detailed balance holds).  Capability parity with
    reference `random_rotate_quaternion` (`Ewald/quaternions.jl:158-182`).
    q: (..., 4); dphi_max scalar or (...,).  Returns (..., 4), renormalized.
    """
    kax, kang = jax.random.split(key)
    axis = random_unit_vector(kax, q.shape[:-1], dtype=q.dtype)
    u = jax.random.uniform(kang, q.shape[:-1], dtype=q.dtype)
    angle = (2.0 * u - 1.0) * dphi_max
    half = 0.5 * angle
    rot = jnp.concatenate(
        [jnp.cos(half)[..., None], jnp.sin(half)[..., None] * axis], axis=-1
    )
    return normalize(quat_mul(rot, q))


def rot_to_quat(r):
    """Rotation matrix (3,3) -> unit quaternion (w,x,y,z), host-side NumPy
    (Shepperd's method, numerically robust for all sign cases)."""
    import numpy as np

    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (r[2, 1] - r[1, 2]) / s
        y = (r[0, 2] - r[2, 0]) / s
        z = (r[1, 0] - r[0, 1]) / s
    elif r[0, 0] >= r[1, 1] and r[0, 0] >= r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2.0
        w = (r[2, 1] - r[1, 2]) / s
        x = 0.25 * s
        y = (r[0, 1] + r[1, 0]) / s
        z = (r[0, 2] + r[2, 0]) / s
    elif r[1, 1] >= r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2.0
        w = (r[0, 2] - r[2, 0]) / s
        x = (r[0, 1] + r[1, 0]) / s
        y = 0.25 * s
        z = (r[1, 2] + r[2, 1]) / s
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2.0
        w = (r[1, 0] - r[0, 1]) / s
        x = (r[0, 2] + r[2, 0]) / s
        y = (r[1, 2] + r[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def fit_quaternions(body, rel_coords):
    """Recover per-molecule quaternions from actual coordinates (host-side).

    body (M,P,3) templates (COM at origin), rel_coords (M,P,3) actual
    COM-relative atom positions.  Kabsch fit per molecule: the returned
    q satisfies rel ~= R(q) @ body.  Exact when molecules are rigid copies
    of the template (e.g. the NIST SPC/E samples).
    """
    import numpy as np

    M = body.shape[0]
    quats = np.zeros((M, 4))
    for m in range(M):
        h = body[m].T @ rel_coords[m]  # (3,3): sum_p b_p x_p^T
        u, _, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        rm = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        quats[m] = rot_to_quat(rm)
    return quats


def center_of_mass(coords, masses):
    """Mass-weighted center; coords (..., P, 3), masses broadcastable to (..., P)."""
    m = jnp.broadcast_to(jnp.asarray(masses, dtype=coords.dtype), coords.shape[:-1])
    tot = jnp.sum(m, axis=-1)
    return jnp.sum(coords * m[..., None], axis=-2) / tot[..., None]


def body_frame_from_template(coords, masses):
    """Shift a molecule template so its center of mass is the origin.

    Reference: `BodyFixed` + `Shift_COM_to_Zero!` (`Ewald/structs.jl:217-245`,
    `Ewald/auxillary.jl:181-203`).  coords (P, 3), masses (P,) -> (P, 3).
    """
    com = center_of_mass(coords, masses)
    return coords - com[..., None, :]
