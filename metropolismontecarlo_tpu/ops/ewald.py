"""Ewald summation (structure factors as dense matmuls, carried
incremental state for single-molecule moves).

Capability parity with reference `Ewald/ewalds.jl`:
  * k-vector table + coefficients  (`PrepareEwaldVariables`, :45-103)
  * real-space erfc sum            (`EwaldReal`, :293-376)
  * full reciprocal sum            (`RecipLong`, :537-604)
  * incremental per-move update    (`RecipMove`, :718-826)
  * self term                      (`EwaldSelf`, :829-833)
plus the NIST-convention intramolecular correction (constant for rigid
molecules; the reference omits it, shifting its absolute energies).

Design notes:
  * The reference builds exp(ik.r) by complex recurrences per atom; here
    the phases are one (A, 3) @ (3, K) matmul and the structure factor one
    (A,) @ (A, K) contraction, batched over chains by vmap.
  * Structure factors are stored as real (K, 2) [re, im] arrays so the MC
    scan carry stays real-valued.
  * Incremental updates touch only the moved molecule's P atoms: O(P*K).

Conventions: kappa in 1/Angstrom (the reference uses kappa = 5.6/box,
`Ewald/main.jl:290`); k-space cutoff 0 < |k|^2 < ksq_max in integer units
with nk = 5, ksq_max = 27 (strict <, `Ewald/ewalds.jl:62`); energies are
returned in Kelvin via `factor` = e^2/(4 pi eps0 kB) in K*Angstrom.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import erfc as _erfc

from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR


def make_kvectors(nk=5, ksq_max=27, strict=True):
    """Enumerate half-space integer k-vectors (host-side, static shapes).

    kx in [0, nk], ky/kz in [-nk, nk], 0 < |k|^2 < ksq_max (or <= if not
    strict); weight 2 for kx > 0 (the kx < 0 half-space is folded in via
    S(-k) = conj(S(k))).  Returns (kvecs (K,3) int32, weights (K,) float64)
    as NumPy arrays (static, baked into jitted programs).
    """
    ks, ws = [], []
    for kx in range(0, nk + 1):
        for ky in range(-nk, nk + 1):
            for kz in range(-nk, nk + 1):
                k2 = kx * kx + ky * ky + kz * kz
                if k2 == 0:
                    continue
                if (k2 < ksq_max) if strict else (k2 <= ksq_max):
                    ks.append((kx, ky, kz))
                    ws.append(2.0 if kx > 0 else 1.0)
    return np.asarray(ks, dtype=np.int32), np.asarray(ws, dtype=np.float64)


def tune_parameters(box, r_cut, tol=1e-5):
    """Accuracy-targeted Ewald parameters: (kappa_L, nk, ksq_max) such
    that both truncation errors sit at the RELATIVE level `tol`.

    The reference hardcodes kappa = 5.6/box with nk = 5 (`Ewald/
    main.jl:290`, `ewalds.jl:62`) — adequate for its one water box,
    wrong for anything else.  The controlling magnitudes are

      real-space tail  ~ erfc(kappa r_cut)          (per-pair weight)
      k-space tail     ~ exp(-k~_max^2 / 4 kappa^2) (last shell weight)

    so set kappa r_cut = sqrt(ln 1/tol) (the erfc argument that drives
    its exponential to tol) and k~_max = 2 kappa sqrt(ln 1/tol), i.e.
    integer n_max = ceil(box ln(1/tol) / (pi r_cut)).  Correctness is
    gated the only way that is convention-free: the TOTAL Coulomb
    energy (real + recip + self + intra) is kappa-INDEPENDENT once both
    sums are converged, so tuned parameter sets at different r_cut must
    agree with each other and tighter tolerances must agree more
    (tests/test_nist_golden.py::test_tuned_parameters_kappa_invariance).

    Returns (kappa_L, nk, ksq_max) matching RunParams' conventions
    (kappa = kappa_L / box; 0 < |k|^2 < ksq_max in integer units).
    """
    assert 0.0 < tol < 1.0 and r_cut > 0.0 and box > 0.0
    s = float(np.sqrt(np.log(1.0 / tol)))
    kappa = s / r_cut
    nk = int(np.ceil(box * s * kappa / np.pi))
    return kappa * box, nk, nk * nk + 1


def cfac_coeffs(kvecs, weights, kappa, box, dtype=None):
    """Per-k reciprocal coefficients: w * (2 pi / V) exp(-k~^2/4 kappa^2)/k~^2
    with k~ = 2 pi k / box.  jit-friendly in `box` (needed for NPT)."""
    kvecs = jnp.asarray(kvecs)
    weights = jnp.asarray(weights, dtype=dtype)
    k2 = jnp.sum(kvecs.astype(weights.dtype) ** 2, axis=-1)
    kt2 = (2.0 * jnp.pi / box) ** 2 * k2
    vol = box**3
    return weights * (2.0 * jnp.pi / vol) * jnp.exp(-kt2 / (4.0 * kappa**2)) / kt2


def structure_factor_direct(coords, charges, kvecs, box):
    """S(k) = sum_i q_i exp(i k~.r_i) as a real (..., K, 2) array.

    coords (..., A, 3), charges (..., A) or (A,).  One (A,3)@(3,K) phase
    matmul + two (A,)@(A,K) contractions, but the K*A cos/sin grid is
    transcendental-bound; prefer `structure_factor` (the recurrence
    path) for large A.
    """
    kmat = jnp.asarray(kvecs, dtype=coords.dtype)
    # HIGHEST: a reduced-precision f32 matmul (bf16 or TF32 passes)
    # injects O(0.1 rad) phase errors at |phase| ~ 30 — catastrophic
    # for S(k)
    phase = (2.0 * jnp.pi / box) * jnp.einsum(
        "...ad,kd->...ak", coords, kmat,
        precision=jax.lax.Precision.HIGHEST)
    q = jnp.broadcast_to(jnp.asarray(charges, dtype=coords.dtype), phase.shape[:-1])
    hi = jax.lax.Precision.HIGHEST
    re = jnp.einsum("...a,...ak->...k", q, jnp.cos(phase), precision=hi)
    im = jnp.einsum("...a,...ak->...k", q, jnp.sin(phase), precision=hi)
    return jnp.stack([re, im], axis=-1)


def structure_factor(coords, charges, kvecs, box):
    """S(k) = sum_i q_i exp(i k~.r_i) as a real (..., K, 2) array.

    Recurrence path (the reference's eikx/eiky/eikz tables,
    `Ewald/ewalds.jl:558-585`, rebuilt as dense array work): exp(i k.r) =
    ex[kx] ey[ky] ez[kz] with per-axis tables built by COMPLEX
    MULTIPLICATION from one base angle per axis — 3A sin/cos total
    instead of K*A, with the per-k table selection done by static
    one-hot MATMULS (never a traced gather) and the triple product +
    charge contraction as elementwise work.  Phase error accumulates
    over <= ~3 nk complex products (~nk eps, same order as the direct
    path's eps*|phase|); exact agreement with `structure_factor_direct`
    is gated in tests/test_ops.py.

    Falls back to the direct path for small A (pose rows: the tables
    would cost more than they save).
    """
    A = coords.shape[-2]
    try:
        # the recurrence needs STATIC k-vectors (they index the tables
        # at trace time); a traced kvecs argument (energy_breakdown_jit
        # passes them as jit operands) falls back to the direct path
        kv = np.asarray(kvecs)
    except jax.errors.TracerArrayConversionError:
        return structure_factor_direct(coords, charges, kvecs, box)
    if A < 32 or kv.shape[0] < 16:
        return structure_factor_direct(coords, charges, kvecs, box)
    dtype = coords.dtype
    nx = int(kv[:, 0].max())
    ny = int(np.abs(kv[:, 1]).max())
    nz = int(np.abs(kv[:, 2]).max())
    # extreme-K guard: the baked selection one-hot below is
    # (ngrid, K) f32 HLO; past ~4M entries (16 MB) the constant bloats
    # the program — such rebuilds fall back to the direct path
    if (nx + 1) * (2 * ny + 1) * (2 * nz + 1) * kv.shape[0] > 4_000_000:
        return structure_factor_direct(coords, charges, kvecs, box)
    ang = (2.0 * jnp.pi / box) * coords                  # (..., A, 3)

    def axis_tables(a, n):
        """[(re, im)] for e^{i m a}, m = 0..n (each (..., A))."""
        cr, ci = jnp.cos(a), jnp.sin(a)
        out_r, out_i = [jnp.ones_like(a)], [jnp.zeros_like(a)]
        for _ in range(n):
            pr, pi = out_r[-1], out_i[-1]
            out_r.append(pr * cr - pi * ci)
            out_i.append(pr * ci + pi * cr)
        return jnp.stack(out_r, -1), jnp.stack(out_i, -1)   # (..., A, n+1)

    ex_r, ex_i = axis_tables(ang[..., 0], nx)
    ey_r, ey_i = axis_tables(ang[..., 1], ny)
    ez_r, ez_i = axis_tables(ang[..., 2], nz)

    hi = jax.lax.Precision.HIGHEST

    def signed(tab_r, tab_i):
        """(.., A, n+1) positive-m tables -> (.., A, 2n+1) signed range
        m = -n..n via conjugation (flip + negate imag, drop dup m=0)."""
        neg_r = jnp.flip(tab_r[..., 1:], -1)
        neg_i = -jnp.flip(tab_i[..., 1:], -1)
        return (jnp.concatenate([neg_r, tab_r], -1),
                jnp.concatenate([neg_i, tab_i], -1))

    eys_r, eys_i = signed(ey_r, ey_i)            # (..., A, 2ny+1)
    ezs_r, ezs_i = signed(ez_r, ez_i)            # (..., A, 2nz+1)
    q = jnp.broadcast_to(jnp.asarray(charges, dtype), coords.shape[:-1])

    # contract the ATOM axis first, per kx value: T_m[ky, kz] =
    # sum_a (q_a ex[a,m]) ey[a,ky] ez[a,kz] — a batched complex
    # (2ny+1, A)@(A, 2nz+1) matmul per m over the FULL signed
    # (ky, kz) grid.  This never materializes an (A, K) tensor (the
    # first draft did, six of them — ~7 GB of HBM traffic for the
    # Gibbs volume shapes; HBM-bound at 30 ms.  Contracting atoms
    # first leaves only the small (.., A, 2n+1) tables + the tiny
    # (nx+1, 2ny+1, 2nz+1) grid in memory).
    def dot(u, v):
        return jnp.einsum("...ak,...al->...kl", u, v, precision=hi)

    t_r, t_i = [], []
    for m in range(nx + 1):
        w_r = q * ex_r[..., m]
        w_i = q * ex_i[..., m]
        u_r = w_r[..., None] * eys_r - w_i[..., None] * eys_i
        u_i = w_r[..., None] * eys_i + w_i[..., None] * eys_r
        t_r.append(dot(u_r, ezs_r) - dot(u_i, ezs_i))
        t_i.append(dot(u_r, ezs_i) + dot(u_i, ezs_r))
    grid_r = jnp.stack(t_r, -3)                  # (..., nx+1, NY, NZ)
    grid_i = jnp.stack(t_i, -3)

    # pick of the K valid k-vectors from the grid by a BAKED one-hot
    # matmul: XLA constant-folds the selection into the dot (a
    # last-axis jnp.take or a runtime-built one-hot cannot be folded).
    # The baked constant is (ngrid, K) f32 — fine for common K, but
    # ~300 MB of HLO at tuned cap-256 Gibbs shapes (K ~ 6e3, ngrid ~
    # 1.3e4) — the guard at the top of this function routes such
    # extreme-K cases to the direct path instead.
    ngrid = (nx + 1) * (2 * ny + 1) * (2 * nz + 1)
    flat_idx = (kv[:, 0].astype(np.int64) * (2 * ny + 1)
                + (kv[:, 1] + ny)) * (2 * nz + 1) + (kv[:, 2] + nz)
    onehot = np.zeros((ngrid, kv.shape[0]), np.float32)
    onehot[flat_idx, np.arange(kv.shape[0])] = 1.0
    onehot = jnp.asarray(onehot, dtype)
    shp = grid_r.shape[:-3] + (ngrid,)
    re = jnp.einsum("...g,gk->...k", grid_r.reshape(shp), onehot,
                    precision=hi)
    im = jnp.einsum("...g,gk->...k", grid_i.reshape(shp), onehot,
                    precision=hi)
    return jnp.stack([re, im], axis=-1)


def delta_structure_factor(ra_old, ra_new, charges, kvecs, box):
    """Structure-factor delta for one moved molecule: S_new - S_old.

    ra_old/ra_new (..., P, 3), charges (..., P) or (P,) -> (..., K, 2).
    O(P*K) — the reference's RecipMove trick (`Ewald/ewalds.jl:718-826`)
    vectorized over chains.
    """
    s_new = structure_factor(ra_new, charges, kvecs, box)
    s_old = structure_factor(ra_old, charges, kvecs, box)
    return s_new - s_old


def recip_energy(sfac, cfac, factor=COULOMB_FACTOR):
    """E_fourier = factor * sum_k cfac_k |S(k)|^2; sfac (..., K, 2)."""
    return factor * jnp.sum(cfac * jnp.sum(sfac * sfac, axis=-1), axis=-1)


def recip_energy_delta(sfac_old, dsfac, cfac, factor=COULOMB_FACTOR):
    """E_fourier(S_old + dS) - E_fourier(S_old), computed stably as
    factor * sum_k cfac (2 S_old.dS + |dS|^2)."""
    cross = 2.0 * jnp.sum(sfac_old * dsfac, axis=-1) + jnp.sum(dsfac * dsfac, axis=-1)
    return factor * jnp.sum(cfac * cross, axis=-1)


def real_space_sum(d2, qq, mask, kappa, factor=COULOMB_FACTOR):
    """Masked real-space sum: factor * sum qq erfc(kappa r)/r over pairs.

    d2 (..., P, A) squared distances (pre-floored), qq (..., P, A) charge
    products, mask (..., P, A) or broadcastable bool.  Reduces the trailing
    two axes.
    """
    d2s = jnp.where(mask, d2, jnp.ones((), d2.dtype))
    r = jnp.sqrt(d2s)
    term = qq * _erfc(kappa * r) / r
    return factor * jnp.sum(
        jnp.where(mask, term, jnp.zeros((), d2.dtype)), axis=(-1, -2)
    )


_TWO_OVER_RTPI = 1.1283791670955126  # 2/sqrt(pi)


def real_space_virial(d2, qq, dot_ij_ab, mask, kappa, style, qq_cut=None,
                      factor=COULOMB_FACTOR):
    """EXACT molecular-virial contribution of the real-space Coulomb sum,
    for the model sampled by this framework (kappa = kappa_L / box, so
    kappa carries a volume dependence).

    Definition: W = -3V dU/dV under rigid-molecule COM scaling, so that
    P = rho T + W/(3V) equals the finite-difference pressure exactly.
    Two pieces per pair:

      * force term      (r_ij_com . r_ab) * (-du/dr)/r, with
        -du/dr = factor qq [erfc(kr)/r^2 + (2k/sqrt(pi)) e^{-k^2 r^2}/r]
      * kappa term      kappa * du/dkappa = -factor qq (2k/sqrt(pi)) e^{-k^2 r^2}
        (the chain-rule term from dkappa/dV = -kappa/3V; for Wolf the
        r-independent shift adds +factor qq (2k/sqrt(pi)) e^{-k^2 rc^2})

    Replaces the reference's E/3 approximation (`Ewald/energy.jl:1004-1021`).
    d2/qq/mask as in real_space_sum; dot_ij_ab (..., P, A) is
    r_ij_com . r_ab per pair.  Reduces the trailing two axes.
    """
    d2s = jnp.where(mask, d2, jnp.ones((), d2.dtype))
    r = jnp.sqrt(d2s)
    gauss = jnp.exp(-(kappa * kappa) * d2s)
    if style == "bare":
        w = qq * dot_ij_ab / (d2s * r)
    else:
        w = qq * (dot_ij_ab * (_erfc(kappa * r) / (d2s * r)
                               + kappa * _TWO_OVER_RTPI * gauss / d2s)
                  - kappa * _TWO_OVER_RTPI * gauss)
        if style == "wolf":
            w = w + qq * kappa * _TWO_OVER_RTPI \
                * jnp.exp(-(kappa * qq_cut) ** 2)
        elif style != "ewald":
            raise ValueError(style)
    return factor * jnp.sum(jnp.where(mask, w, jnp.zeros((), d2.dtype)),
                            axis=(-1, -2))


def recip_virial(sfac, cfac, coords, com_of_atom, charges, kvecs, box,
                 factor=COULOMB_FACTOR):
    """EXACT molecular virial of the reciprocal Ewald sum (closed form).

    With kappa = kappa_L/box, the Gaussian exp(-k~^2/4 kappa^2) is
    invariant under isotropic scaling, so

      W_recip = E_recip - 2 factor sum_k cfac_k Im[conj(S_k) T_k],
      T_k     = sum_a q_a (k~ . d_a) exp(i k~ . r_a),

    where d_a = r_a - R_mol(a) is the (minimum-imaged, scale-invariant)
    rigid-body offset of atom a from its molecule's COM.  Derivation:
    k~.R_m is scale-invariant while k~.d_a ~ V^{-1/3}, so
    dS/dV = -i T/(3V) and d|S|^2/dV = (2/3V) Im[conj(S) T]; together with
    dcfac/dV = -cfac/(3V) this gives W = -3V dE/dV as above.

    coords (..., A, 3); com_of_atom (..., A, 3); charges (A,) or batched.
    Returns W_recip (scalar per batch element).
    """
    d = coords - com_of_atom
    d = d - box * jnp.round(d / box)
    kmat = jnp.asarray(kvecs, dtype=coords.dtype)
    hi = jax.lax.Precision.HIGHEST
    tpl = 2.0 * jnp.pi / box
    phase = tpl * jnp.einsum("...ad,kd->...ak", coords, kmat, precision=hi)
    kdotd = tpl * jnp.einsum("...ad,kd->...ak", d, kmat, precision=hi)
    q = jnp.broadcast_to(jnp.asarray(charges, coords.dtype), phase.shape[:-1])
    t_re = jnp.einsum("...a,...ak->...k", q, kdotd * jnp.cos(phase),
                      precision=hi)
    t_im = jnp.einsum("...a,...ak->...k", q, kdotd * jnp.sin(phase),
                      precision=hi)
    im_sbar_t = sfac[..., 0] * t_im - sfac[..., 1] * t_re
    e_recip = recip_energy(sfac, cfac, factor)
    return e_recip - 2.0 * factor * jnp.sum(cfac * im_sbar_t, axis=-1)


def ewald_intra_kappa(coords_mp, charges_mp, kappa, box,
                      factor=COULOMB_FACTOR):
    """kappa-derivative virial of the intramolecular correction:
    W = kappa dE_intra/dkappa = -factor (2k/sqrt(pi)) sum qq e^{-k^2 r^2}
    (intramolecular distances are invariant under rigid COM scaling)."""
    dr = coords_mp[..., :, None, :] - coords_mp[..., None, :, :]
    dr = dr - box * jnp.round(dr / box)
    d2 = jnp.maximum(jnp.sum(dr * dr, axis=-1), jnp.asarray(1e-12, dr.dtype))
    qq = charges_mp[..., :, None] * charges_mp[..., None, :]
    P = coords_mp.shape[-2]
    iu = jnp.triu(jnp.ones((P, P), dtype=bool), k=1)
    term = jnp.where(iu, qq * jnp.exp(-(kappa * kappa) * d2), 0.0)
    return -factor * kappa * _TWO_OVER_RTPI * jnp.sum(term, axis=(-1, -2, -3))


def overlap_any(d2, qq, mask, d2_overlap=0.5):
    """Hard-overlap veto: any included pair closer than sqrt(d2_overlap)
    with opposite charges (reference `Ewald/ewalds.jl:359-361`)."""
    bad = (d2 < d2_overlap) & (qq < 0.0) & mask
    return jnp.any(bad, axis=(-1, -2))


def ewald_self(charges, kappa, factor=COULOMB_FACTOR):
    """E_self = -factor * kappa/sqrt(pi) * sum q_i^2 (`EwaldSelf`, :829-833)."""
    q = jnp.asarray(charges)
    return -factor * kappa / jnp.sqrt(jnp.pi) * jnp.sum(q * q, axis=-1)


def ewald_intra(coords_mp, charges_mp, kappa, box, factor=COULOMB_FACTOR):
    """NIST-convention intramolecular correction (constant for rigid bodies):

      E_intra = -factor * sum_mol sum_{i<j in mol} q_i q_j erf(kappa r_ij)/r_ij

    removing the spurious intramolecular interactions contained in the
    reciprocal sum.  coords_mp (..., M, P, 3), charges_mp (..., M, P).
    Minimum-image IS applied: stored configurations (e.g. the NIST SPC/E
    samples) wrap atoms of boundary-straddling molecules independently.
    """
    dr = coords_mp[..., :, None, :] - coords_mp[..., None, :, :]
    dr = dr - box * jnp.round(dr / box)
    d2 = jnp.maximum(jnp.sum(dr * dr, axis=-1), jnp.asarray(1e-12, dr.dtype))
    r = jnp.sqrt(d2)
    qq = charges_mp[..., :, None] * charges_mp[..., None, :]
    P = coords_mp.shape[-2]
    iu = jnp.triu(jnp.ones((P, P), dtype=bool), k=1)
    erf = 1.0 - _erfc(kappa * r)
    term = jnp.where(iu, qq * erf / r, 0.0)
    return -factor * jnp.sum(term, axis=(-1, -2, -3))


def surface_dipole(coords, com_of_atom, charges, box):
    """Total dipole M = sum_i q_i (r_i - R_mol(i)) (..., 3), the sum of
    molecular dipoles.  Equal to sum q_i r_i for charge-neutral molecules
    but, unlike that form, translation-invariant per molecule and hence
    continuous under periodic wrapping.  The rigid offset is minimum-
    imaged like everywhere else."""
    d = coords - com_of_atom
    d = d - box * jnp.round(d / box)
    q = jnp.asarray(charges, coords.dtype)
    return jnp.einsum("...a,...ad->...d", jnp.broadcast_to(q, d.shape[:-1]),
                      d, precision=jax.lax.Precision.HIGHEST)


def surface_term(coords, com_of_atom, charges, box, factor=COULOMB_FACTOR):
    """Ewald surface (dipole) term for vacuum boundary (epsilon' = 1):

      E_surf = factor * 2 pi / (3 V) * |M|^2

    The reference's written-but-disabled `TinfoilBoundary`
    (`Ewald/ewalds.jl:835-844`); identical to its sum-q_i-r_i form for
    neutral molecules.  Omitting it (the default) is the tinfoil /
    conducting boundary convention, which all NIST golden values use.
    Virial: E ~ 1/V with |M|^2 scale-invariant, so w_surf = 3 E_surf
    (same pattern as the LRC term)."""
    m = surface_dipole(coords, com_of_atom, charges, box)
    vol = box**3
    return factor * 2.0 * jnp.pi / (3.0 * vol) * jnp.sum(m * m, axis=-1)
