"""Long-range (tail) corrections for truncated LJ interactions.

Capability parity with reference `Ewald/auxillary.jl:16-35`
(`potential_lrc`, `pressure_lrc`, `pressure_delta`) and the per-type
`ener_corr`/`press_corr` (`Ewald/energy.jl:514-614`), generalized to
arbitrary multi-species mixtures.

For u(r) = 4 eps [(sigma/r)^12 - (sigma/r)^6] truncated at r_cut, the
standard corrections assuming g(r)=1 beyond the cutoff are

  U_lrc = (8 pi / 3V) sum_ab N_a N_b eps_ab sigma_ab^3
          [ (1/3) (sigma_ab/r_cut)^9 - (sigma_ab/r_cut)^3 ]
  P_lrc = (16 pi / 3V^2) sum_ab N_a N_b eps_ab sigma_ab^3
          [ (2/3) (sigma_ab/r_cut)^9 - (sigma_ab/r_cut)^3 ]
"""

import jax.numpy as jnp
import numpy as np


def mol_tail_coeff(tvec_a, tvec_b, eps_table, sig_table, r_cut):
    """Molecular (species-level) tail coefficient c_ab, NumPy, static.

    With per-molecule atom-type counts t_s (T,) for each species, the
    atom-type counts of a configuration are N^at = sum_s N_s t_s, so

        U_lrc = (8 pi / 3V) sum_ss' N_s N_s' c_ss',
        c_ss' = t_s^T C t_s',
        C_ab  = eps_ab sigma_ab^3 [ (1/3)(sigma_ab/r_cut)^9
                                    - (sigma_ab/r_cut)^3 ]

    — U_lrc is QUADRATIC in the molecule counts, which makes every
    exchange/transfer/flip delta affine in N, like the reference-Wolf
    c*Q^2 term (`mc/widom.py:wolf_const_coeff`).
    The fluctuating-N ensembles (gcmc/gibbs/semigrand/tmmc families)
    use this; fixed-N code uses `lrc_energy` directly.  Exactly
    consistent: lrc_energy(sum_s N_s t_s, ...) ==
    (8 pi/3V) sum_ss' N_s N_s' mol_tail_coeff(t_s, t_s') (gated in
    tests/test_lrc_exchange.py).
    """
    eps = np.asarray(eps_table, np.float64)
    sig = np.asarray(sig_table, np.float64)
    sc3 = (sig / float(r_cut)) ** 3
    C = eps * sig**3 * (sc3**3 / 3.0 - sc3)
    ta = np.asarray(tvec_a, np.float64)
    tb = np.asarray(tvec_b, np.float64)
    return float(ta @ C @ tb)


LRC_PREFACTOR = 8.0 * np.pi / 3.0


def _species_sum(counts, eps_table, sig_table, r_cut):
    counts = jnp.asarray(counts, dtype=eps_table.dtype)
    sc3 = (sig_table / r_cut) ** 3
    sc9 = sc3**3
    nn = counts[:, None] * counts[None, :]
    e_term = jnp.sum(nn * eps_table * sig_table**3 * (sc9 / 3.0 - sc3))
    p_term = jnp.sum(nn * eps_table * sig_table**3 * (2.0 * sc9 / 3.0 - sc3))
    return e_term, p_term


def lrc_energy(counts, eps_table, sig_table, r_cut, volume):
    """Tail energy correction; counts (T,) atoms of each LJ type."""
    e_term, _ = _species_sum(counts, eps_table, sig_table, r_cut)
    return (8.0 * jnp.pi / (3.0 * volume)) * e_term


def lrc_pressure(counts, eps_table, sig_table, r_cut, volume):
    """Tail pressure correction (energy/volume units)."""
    _, p_term = _species_sum(counts, eps_table, sig_table, r_cut)
    return (16.0 * jnp.pi / (3.0 * volume**2)) * p_term


def impulsive_pressure(counts, eps_table, sig_table, r_cut, volume):
    """Impulsive (truncation-discontinuity) pressure of CUT-UNSHIFTED LJ,
    in the standard g(r_cut) ~ 1 approximation (the reference's
    `pressure_delta`, `Ewald/auxillary.jl:30-35`):

      P_imp = (2 pi / 3 V^2) r_cut^3 sum_ab N_a N_b u_ab(r_cut)

    Physics: the pair energy jumps by -u(r_cut) when a pair crosses the
    cutoff, so the ensemble's mechanical pressure differs from the
    smooth-branch virial pressure (dU/dV between crossings — what
    `energy_breakdown` "w" and small-eps finite differences measure) by
    this delta-function term.  Negative for attractive u(r_cut).  Exactly
    zero for the force-shifted ("linear") potential.
    """
    sc3 = (sig_table / r_cut) ** 3
    sc6 = sc3 * sc3
    u_rc = 4.0 * eps_table * (sc6 * sc6 - sc6)
    counts = jnp.asarray(counts, dtype=eps_table.dtype)
    nn = counts[:, None] * counts[None, :]
    return (2.0 * jnp.pi / (3.0 * volume**2)) * r_cut**3 \
        * jnp.sum(nn * u_rc)
