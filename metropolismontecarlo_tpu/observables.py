"""Observables: radial distribution functions, block averages, pressure.

Capability parity with reference C14 (`Pressure` `Ewald/auxillary.jl:
116-123`, LRC corrections, and the RDF post-processor `Ewald/gr.jl` —
which in the reference is non-runnable pseudocode; here it is a real
on-device accumulator, batched over chains).
"""

import jax
import jax.numpy as jnp
import numpy as np


class RDFAccumulator:
    """On-device RDF between two atom-type selections, pooled over chains.

    g(r) is accumulated as a bin-count histogram on device (one
    `bincount` per chain chunk) and normalized on demand:

        g(r) = <n(r)> / (N_i rho_j 4 pi r^2 dr)

    Reference cross-check: SPC/E O-O RDF, Wolf vs Ewald overlay
    (`Ewald/SPC_E water RDF - Wolf & Ewald.png`).
    """

    def __init__(self, system, type_i, type_j, r_max, n_bins=200, chunk=8):
        tid = system.flat(system.type_ids)
        self.idx_i = np.nonzero(tid == type_i)[0]
        self.idx_j = np.nonzero(tid == type_j)[0]
        mol = system.atom_mol_slot[0]
        self.mol_i = mol[self.idx_i]
        self.mol_j = mol[self.idx_j]
        self.same_type = type_i == type_j
        self.r_max = float(r_max)
        self.n_bins = int(n_bins)
        self.chunk = chunk
        self.hist = jnp.zeros((n_bins,), jnp.float64 if jax.config.jax_enable_x64
                              else jnp.float32)
        self.n_samples = 0
        self._vol_sum = 0.0

        ii = jnp.asarray(self.idx_i)
        jj = jnp.asarray(self.idx_j)
        mi = jnp.asarray(self.mol_i)
        mj = jnp.asarray(self.mol_j)
        n_bins_ = self.n_bins
        r_max_ = self.r_max

        def one_chain(coords_t, box):
            ri = coords_t[:, ii]                     # (3, Ni)
            rj = coords_t[:, jj]                     # (3, Nj)
            dr = ri[:, :, None] - rj[:, None, :]
            dr = dr - box * jnp.round(dr / box)
            r = jnp.sqrt(jnp.maximum(jnp.sum(dr * dr, 0), 1e-12))
            inter = mi[:, None] != mj[None, :]
            keep = inter & (r < r_max_)
            bins = jnp.clip((r * (n_bins_ / r_max_)).astype(jnp.int32),
                            0, n_bins_ - 1)
            bins = jnp.where(keep, bins, n_bins_)  # overflow bin, dropped
            return jnp.bincount(bins.reshape(-1), length=n_bins_ + 1)[:n_bins_]

        @jax.jit
        def update(coords_c, box_c, hist):
            from metropolismontecarlo_tpu.utils.chunking import chunked_vmap

            counts = chunked_vmap(one_chain, chunk, coords_c, box_c)
            # cast the per-update counts, never the accumulator: the
            # histogram stays in its own (f64 when available) dtype even
            # for f32 simulation states
            return hist + jnp.sum(counts, axis=0).astype(hist.dtype)

        self._update = update

    def update(self, state):
        self.hist = self._update(state.coords, state.box, self.hist)
        c = state.coords.shape[0]
        self.n_samples += c
        self._vol_sum += float(jnp.sum(state.box**3))

    def result(self):
        """Returns (r_centers, g_r) as NumPy arrays."""
        dr = self.r_max / self.n_bins
        r = (np.arange(self.n_bins) + 0.5) * dr
        if self.n_samples == 0:
            return r, np.zeros(self.n_bins)
        vol_mean = self._vol_sum / self.n_samples
        n_i = len(self.idx_i)
        n_j = len(self.idx_j)
        rho_j = n_j / vol_mean
        shell = 4.0 * np.pi * r**2 * dr
        norm = self.n_samples * n_i * rho_j * shell
        return r, np.asarray(self.hist) / np.maximum(norm, 1e-300)


class MaskedRDFAccumulator:
    """RDF between two atom-type selections under a PER-CHAIN activity
    mask — structure in the grand-canonical/osmotic/Gibbs apps, where
    molecule counts fluctuate (e.g. the solute-solvent g(r) of an
    osmotic run).

    Normalization handles fluctuating N by accumulating the pair
    normalizer sum_c n_i(c) n_j(c) / V(c) alongside the histogram:

        g(r) = sum_c hist_c(r) / (4 pi r^2 dr * sum_c n_i n_j / V)

    which reduces exactly to RDFAccumulator's fixed-N normalization
    when the mask is constant (gated by an equality test).
    """

    def __init__(self, system, type_i, type_j, r_max, n_bins=200, chunk=8):
        tid = system.flat(system.type_ids)
        idx_i = np.nonzero(tid == type_i)[0]
        idx_j = np.nonzero(tid == type_j)[0]
        mol = system.atom_mol_slot[0]
        self.r_max = float(r_max)
        self.n_bins = int(n_bins)
        acc_dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.hist = jnp.zeros((n_bins,), acc_dt)
        self._norm = 0.0

        ii, jj = jnp.asarray(idx_i), jnp.asarray(idx_j)
        mi, mj = jnp.asarray(mol[idx_i]), jnp.asarray(mol[idx_j])
        n_bins_, r_max_ = self.n_bins, self.r_max

        def one_chain(coords_t, box, atom_ok):
            ri = coords_t[:, ii]
            rj = coords_t[:, jj]
            oki = atom_ok[ii]
            okj = atom_ok[jj]
            dr = ri[:, :, None] - rj[:, None, :]
            dr = dr - box * jnp.round(dr / box)
            r = jnp.sqrt(jnp.maximum(jnp.sum(dr * dr, 0), 1e-12))
            keep = (mi[:, None] != mj[None, :]) & (r < r_max_) \
                & oki[:, None] & okj[None, :]
            bins = jnp.clip((r * (n_bins_ / r_max_)).astype(jnp.int32),
                            0, n_bins_ - 1)
            bins = jnp.where(keep, bins, n_bins_)
            h = jnp.bincount(bins.reshape(-1), length=n_bins_ + 1)[:n_bins_]
            norm = jnp.sum(oki) * jnp.sum(okj) / box**3
            return h, norm

        @jax.jit
        def update(coords_c, box_c, ok_c, hist):
            from metropolismontecarlo_tpu.utils.chunking import chunked_vmap

            counts, norms = chunked_vmap(one_chain, chunk, coords_c,
                                         box_c, ok_c)
            return (hist + jnp.sum(counts, axis=0).astype(hist.dtype),
                    jnp.sum(norms))

        self._update = update

    def update(self, coords, box, atom_ok):
        """coords (C, 3, A_pad), box (C,), atom_ok (C, A_pad) bool."""
        self.hist, dn = self._update(coords, box, atom_ok, self.hist)
        self._norm += float(dn)

    def result(self):
        dr = self.r_max / self.n_bins
        r = (np.arange(self.n_bins) + 0.5) * dr
        if self._norm == 0.0:
            return r, np.zeros(self.n_bins)
        shell = 4.0 * np.pi * r**2 * dr
        return r, np.asarray(self.hist) / (shell * self._norm)


class BlockAverager:
    """Running block statistics (the reference's Properties accumulators,
    `Ewald/auxillary.jl:37-45`, as a host-side helper)."""

    def __init__(self):
        self.blocks = []

    def add(self, **metrics):
        self.blocks.append(dict(metrics))

    def mean(self, key, skip=0):
        vals = [b[key] for b in self.blocks[skip:] if key in b]
        return float(np.mean(vals)) if vals else float("nan")

    def sem(self, key, skip=0):
        vals = [b[key] for b in self.blocks[skip:] if key in b]
        if len(vals) < 2:
            return float("nan")
        return float(np.std(vals, ddof=1) / np.sqrt(len(vals)))

    def sem_blocking(self, key, skip=0):
        """Autocorrelation-aware sem of the block series (blocking_
        analysis plateau); falls back to the naive sem when the series
        is too short to block (< 32 entries)."""
        vals = [b[key] for b in self.blocks[skip:] if key in b]
        if len(vals) < 32:
            return self.sem(key, skip)
        return blocking_analysis(vals)["sem"]


def blocking_analysis(series, min_blocks=16):
    """Flyvbjerg-Petersen blocking analysis: the autocorrelation-aware
    standard error of the mean of a correlated time series, plus the
    implied integrated autocorrelation time.

    MC time series (energies, densities, N(t)) are correlated, so the
    naive sem underestimates the true error by sqrt(2 tau).  Blocking
    repeatedly pair-averages the series; the block-level sem estimate
    grows until blocks decorrelate and then plateaus.  The plateau is
    read as the FIRST level whose successor stops growing beyond its
    own sampling noise (s_{k+1} <= s_k (1 + 1/sqrt(2(n_{k+1}-1)))) —
    a max-over-levels reading instead picks up the few-block noise at
    the deepest levels and overestimates tau by ~30% (measured on the
    AR(1) gate).

    Returns dict(mean, sem_naive, sem, tau, n_levels): tau is the
    integrated autocorrelation time implied by sem/sem_naive
    (tau = 0.5 for white noise, here floored at 0.5).  Gated against an
    AR(1) process with known tau in tests/test_io_observables.py.

    series: 1-D array-like (host); per-chain series must be analyzed
    per chain (chains are independent — pool the MEANS, not the
    concatenation, or the chain boundaries fake decorrelation).
    """
    x = np.asarray(series, np.float64).ravel()
    n = x.size
    if n < 2 * min_blocks:
        raise ValueError(f"need >= {2 * min_blocks} samples, got {n}")
    mean = float(x.mean())
    sem_naive = float(x.std(ddof=1) / np.sqrt(n))
    levels = []                      # (n_blocks, sem) per blocking level
    while x.size >= min_blocks:
        levels.append((x.size, float(x.std(ddof=1) / np.sqrt(x.size))))
        x = 0.5 * (x[: x.size // 2 * 2 : 2] + x[1 : x.size // 2 * 2 : 2])
    sem = levels[-1][1]              # fallback: deepest level (no plateau)
    for (_, s_k), (n_k1, s_k1) in zip(levels, levels[1:]):
        if s_k1 <= s_k * (1.0 + 1.0 / np.sqrt(2.0 * (n_k1 - 1))):
            sem = s_k
            break
    tau = max(0.5, 0.5 * (sem / sem_naive) ** 2) if sem_naive > 0 else 0.5
    return dict(mean=mean, sem_naive=sem_naive, sem=sem, tau=tau,
                n_levels=len(levels))


def dielectric_constant(m2_mean, m_mean, vol_mean, temp):
    """Static dielectric constant from total-dipole fluctuations under
    tinfoil (conducting) boundary conditions — the Ewald convention this
    framework samples by default (the surface term is off):

        eps = 1 + (4 pi / 3) * factor * (<M^2> - |<M>|^2) / (V T)

    with M the total dipole in e*Angstrom (sum of molecular dipoles),
    V in Angstrom^3, T in Kelvin, and factor = e^2/(4 pi eps0 kB) the
    framework's Coulomb constant (utils.constants) making the ratio
    dimensionless.  Neumann, Mol. Phys. 50, 841 (1983).

    m2_mean: scalar <M.M>;  m_mean: (3,) <M> (zero by symmetry in bulk,
    but subtracting it removes the finite-sample offset).
    """
    from metropolismontecarlo_tpu.utils.constants import COULOMB_FACTOR

    m_mean = np.asarray(m_mean, np.float64)
    dm2 = float(m2_mean) - float(np.dot(m_mean, m_mean))
    return 1.0 + (4.0 * np.pi / 3.0) * COULOMB_FACTOR * dm2 / (
        float(vol_mean) * float(temp))


class DipoleAccumulator:
    """Total-dipole moments pooled over chains and samples, for the
    dielectric constant and the Kirkwood factor.

    M per chain is the sum of MOLECULAR dipoles sum_i q_i (r_i - R_mol)
    (ops.ewald.surface_dipole): translation-invariant per molecule, so it
    is continuous when molecules wrap across the periodic boundary —
    sum q_i r_i is not.  Beyond-parity observable (the reference has no
    dielectric machinery; its own Wolf-vs-Ewald RDF cross-check is the
    closest analog).

    Pools all chains: only use on equal-temperature ladders (NVT/NPT
    ensembles; exclude REMC multi-temperature states).
    """

    def __init__(self, system, chunk=8):
        from metropolismontecarlo_tpu.ops.ewald import surface_dipole
        from metropolismontecarlo_tpu.utils.chunking import chunked_vmap

        A = system.n_atoms
        charges = jnp.asarray(system.flat(system.charges))
        mol_id = jnp.asarray(system.mol_of_atom_padded[:A])
        # per-molecule dipole magnitude (rigid => constant): mu from the
        # body template, for the Kirkwood factor g_K = <M^2>/(N mu^2)
        body = np.asarray(system.body, np.float64)
        qs = np.asarray(system.charges, np.float64)
        mu_mol = np.linalg.norm((qs[..., None] * body).sum(axis=1), axis=-1)
        self.n_polar = int(np.sum(mu_mol > 1e-12))
        self.mu2_sum = float(np.sum(mu_mol**2))

        def one_chain(coords_t, com, box):
            return surface_dipole(coords_t[:, :A].T, com[mol_id],
                                  charges.astype(coords_t.dtype), box)

        # accumulate in f64 when available; on f32-only backends the
        # per-update sums stay f32 (fine: ~2k chains x O(100) magnitudes)
        # and the running totals are f64 on the host
        acc_dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

        @jax.jit
        def moments(coords_c, com_c, box_c):
            m = chunked_vmap(one_chain, chunk, coords_c, com_c, box_c)
            return (jnp.sum(m, axis=0, dtype=acc_dt),
                    jnp.sum(jnp.sum(m * m, axis=-1), dtype=acc_dt))

        self._moments = moments
        self.m_sum = np.zeros(3)
        self.m2_sum = 0.0
        self.n_samples = 0
        self._vol_sum = 0.0
        self._temp_sum = 0.0

    def update(self, state):
        ms, m2s = self._moments(state.coords, state.com, state.box)
        self.m_sum += np.asarray(ms)
        self.m2_sum += float(m2s)
        c = state.coords.shape[0]
        self.n_samples += c
        self._vol_sum += float(jnp.sum(state.box**3))
        self._temp_sum += float(jnp.sum(state.temp))

    def result(self):
        """dict(epsilon, g_kirkwood, m_mean (3,), m2_mean, n_samples)."""
        if self.n_samples == 0:
            return dict(epsilon=float("nan"), g_kirkwood=float("nan"),
                        m_mean=np.zeros(3), m2_mean=float("nan"),
                        n_samples=0)
        n = self.n_samples
        m_mean = self.m_sum / n
        m2_mean = self.m2_sum / n
        eps = dielectric_constant(m2_mean, m_mean, self._vol_sum / n,
                                  self._temp_sum / n)
        g_k = (m2_mean / self.mu2_sum) if self.mu2_sum > 0 else float("nan")
        return dict(epsilon=eps, g_kirkwood=g_k, m_mean=m_mean,
                    m2_mean=m2_mean, n_samples=n)


class StructureFactorAccumulator:
    """Static structure factor S(k) of one atom-type selection, pooled
    over chains, on the box-commensurate k-grid:

        S(k) = <|sum_j exp(i k.r_j)|^2> / N_sel,   k = (2 pi / L) n

    radially averaged over integer shells |n|^2.  Uses the same
    phase matmuls as the Ewald module (ops.ewald.
    structure_factor with unit weights, precision=HIGHEST — bf16 phases
    are O(0.1 rad) wrong).  Beyond-parity observable (the reference has
    no S(k) machinery); complements the RDF: exact closed forms exist
    for ideal gas (S = 1) and perfect lattices (Bragg peaks S = N),
    which the tests pin.

    NVT-intended: k tracks the (mean) box; on NPT states the shells
    stay integer-exact but the reported k uses the running mean L.
    """

    def __init__(self, system, type_sel=None, n_max=6, chunk=8):
        from metropolismontecarlo_tpu.ops.ewald import (
            make_kvectors,
            structure_factor,
        )
        from metropolismontecarlo_tpu.utils.chunking import chunked_vmap

        tid = np.asarray(system.flat(system.type_ids))
        sel = (np.arange(system.n_atoms) if type_sel is None
               else np.nonzero(tid == type_sel)[0])
        if len(sel) == 0:
            raise ValueError(f"no atoms of type {type_sel}")
        self.n_sel = len(sel)
        # full shells: every |n|^2 <= n_max^2 (non-strict), kx-half-space
        kvecs, kw = make_kvectors(n_max, n_max * n_max, strict=False)
        keep = np.max(np.abs(kvecs), axis=1) <= n_max
        kvecs, kw = kvecs[keep], kw[keep]
        self.ksq = np.sum(kvecs.astype(np.int64) ** 2, axis=1)
        self.shells = np.unique(self.ksq)
        self._kw = kw
        idx = jnp.asarray(sel)
        kv = jnp.asarray(kvecs)

        def one_chain(coords_t, box):
            r = coords_t[:, idx].T                       # (N_sel, 3)
            s = structure_factor(r, jnp.ones((), coords_t.dtype), kv, box)
            return jnp.sum(s * s, axis=-1)               # |rho_k|^2, (K,)

        @jax.jit
        def update(coords_c, box_c):
            acc_dt = (jnp.float64 if jax.config.jax_enable_x64
                      else jnp.float32)
            m = chunked_vmap(one_chain, chunk, coords_c, box_c)
            return jnp.sum(m, axis=0, dtype=acc_dt)

        self._update = update
        self.rho2_sum = np.zeros(len(kvecs))
        self.n_samples = 0
        self._box_sum = 0.0

    def update(self, state):
        self.rho2_sum += np.asarray(self._update(state.coords, state.box),
                                    np.float64)
        self.n_samples += state.coords.shape[0]
        self._box_sum += float(jnp.sum(state.box))

    def result(self):
        """Returns (k (S,), S(k) (S,)) shell-averaged NumPy arrays."""
        l_mean = (self._box_sum / self.n_samples) if self.n_samples else 1.0
        k_out = 2.0 * np.pi / l_mean * np.sqrt(self.shells.astype(np.float64))
        if self.n_samples == 0:
            return k_out, np.zeros(len(self.shells))
        s_k = self.rho2_sum / (self.n_samples * self.n_sel)
        out = np.zeros(len(self.shells))
        for i, sh in enumerate(self.shells):
            m = self.ksq == sh
            out[i] = np.average(s_k[m], weights=self._kw[m])
        return k_out, out


class NPTFluctuations:
    """Volume/energy cross-fluctuations pooled over equal-(T, P) chains,
    for the NPT response functions (beyond-parity observables — the
    reference's NPT machinery is dead pseudocode,
    `Ewald/volumeChange.jl:8-150`):

        kappa_T = (<V^2> - <V>^2) / (T <V>)                 [A^3/K units,
                                                             kB = 1]
        alpha_P = (<V E> - <V><E> + P (<V^2> - <V>^2))
                  / (T^2 <V>)                                [1/K]
        cp_conf = (<dH^2>) / T^2,  H = E_conf + P V          [kB units]

    with E the configurational energy in K and P in K/A^3.  Ideal-gas
    closed forms (eps = 0): kappa_T = 1/P and alpha_P = 1/T exactly,
    independent of the Gamma shape the ln-V Jacobian induces — the
    fluctuation-route analog of `tests/test_mc.py`'s <V> check.
    Updates are O(C) host-side reads of carried state."""

    def __init__(self, pressure):
        self.pressure = float(pressure)
        self.n = 0
        self.s = dict(v=0.0, v2=0.0, e=0.0, ve=0.0, h2=0.0, h=0.0, t=0.0)

    def update(self, state):
        v = np.asarray(state.box, np.float64) ** 3
        e = np.asarray(state.energy, np.float64)
        h = e + self.pressure * v
        self.n += v.shape[0]
        s = self.s
        s["v"] += float(v.sum())
        s["v2"] += float((v * v).sum())
        s["e"] += float(e.sum())
        s["ve"] += float((v * e).sum())
        s["h"] += float(h.sum())
        s["h2"] += float((h * h).sum())
        s["t"] += float(np.sum(np.asarray(state.temp, np.float64)))

    def result(self):
        """dict(kappa_T, alpha_P, cp_conf, v_mean, n_samples)."""
        if self.n < 2:
            return dict(kappa_T=float("nan"), alpha_P=float("nan"),
                        cp_conf=float("nan"), v_mean=float("nan"),
                        n_samples=self.n)
        n = self.n
        s = self.s
        t = s["t"] / n
        v_mean = s["v"] / n
        var_v = s["v2"] / n - v_mean**2
        cov_ve = s["ve"] / n - v_mean * (s["e"] / n)
        var_h = s["h2"] / n - (s["h"] / n) ** 2
        return dict(
            kappa_T=var_v / (t * v_mean),
            alpha_P=(cov_ve + self.pressure * var_v) / (t * t * v_mean),
            cp_conf=var_h / (t * t),
            v_mean=v_mean,
            n_samples=n,
        )


def excess_heat_capacity(e2_mean, e_mean, temp):
    """Configurational (excess) heat capacity per system from energy
    fluctuations:  C_v,ex / kB = (<E^2> - <E>^2) / T^2  (energies in K).
    The reference reports only <E>; the fluctuation route needs the
    second moment this accumulator keeps."""
    return (float(e2_mean) - float(e_mean) ** 2) / float(temp) ** 2


class EnergyFluctuations:
    """First/second moments of the running total energy, pooled over
    equal-temperature chains, for C_v,ex (NVT).  Uses the state's
    accumulated energy (drift-checked against full recomputes every
    block), so updates are O(C)."""

    def __init__(self):
        self.e_sum = 0.0
        self.e2_sum = 0.0
        self.n_samples = 0
        self._temp_sum = 0.0

    def update(self, state):
        e = np.asarray(state.energy, np.float64)
        self.e_sum += float(e.sum())
        self.e2_sum += float((e * e).sum())
        self.n_samples += e.shape[0]
        self._temp_sum += float(jnp.sum(state.temp))

    def result(self):
        if self.n_samples < 2:
            return dict(cv_excess=float("nan"), e_mean=float("nan"),
                        e2_mean=float("nan"), n_samples=self.n_samples)
        n = self.n_samples
        e_mean = self.e_sum / n
        e2_mean = self.e2_sum / n
        cv = excess_heat_capacity(e2_mean, e_mean, self._temp_sum / n)
        return dict(cv_excess=cv, e_mean=e_mean, e2_mean=e2_mean,
                    n_samples=n)


def kirkwood_buff_integral(r, g_r, r_upper=None):
    """Kirkwood-Buff integral G_ij = 4 pi int_0^R (g_ij(r) - 1) r^2 dr
    from an RDF (e.g. `RDFAccumulator.result()` / masked variant).

    KB integrals connect pair structure to mixture thermodynamics
    (partial molar volumes, compressibility, activity derivatives —
    Kirkwood & Buff 1951; Ben-Naim, *Molecular Theory of Solutions*).
    The open-system definition integrates to infinity; a closed
    simulation box's g(r) only reaches ~box/2, so R (default: the last
    bin) acts as the truncation — report G(R) at a plateau of the
    running integral, and remember closed-NVT RDFs carry O(1/N)
    finite-size tails (the muVT/masked accumulators sample the open
    ensemble and converge cleaner).

    Trapezoidal quadrature on the binned centers; exact anchors: the
    ideal gas (g == 1) gives exactly 0 at every R, and a hard unit
    step g = Theta(r - sigma) gives -4/3 pi sigma^3 (the excluded
    volume) in the R -> inf limit.

    Returns G(R) (float) — pass `r_upper` to truncate earlier, e.g. at
    a g(r) plateau.
    """
    r = np.asarray(r, np.float64)
    g = np.asarray(g_r, np.float64)
    if r_upper is not None:
        keep = r <= r_upper
        r, g = r[keep], g[keep]
    integrand = (g - 1.0) * r * r
    return float(4.0 * np.pi * np.trapezoid(integrand, r))


def heat_of_vaporization(state, pressure_fd, masses=None):
    """Molar enthalpy of vaporization from an equilibrated two-box
    Gibbs state (MolGibbsState or BinaryGibbsState):

        dH_vap = h_vap - h_liq,   h_box = U_box/N_box + P_box V_box/N_box

    with each box's own exact dU/dV pressure (pass `pressure_fd` =
    the ensemble's pressure_fd(state), shape (C, 2)) — enthalpy is a
    per-box state function; at coexistence the two pressures agree and
    this reduces to the textbook (u_v - u_l) + P (v_v - v_l).  Returns
    per-chain values in K per molecule (multiply by R = 8.31446e-3
    kJ/mol/K for kJ/mol).

    Exact anchor: an ideal gas has U = 0 and P_box v_box = kT in each
    box, so dH_vap == 0 identically even for boxes NOT at mutual
    mechanical equilibrium (tests/test_io_observables.py).
    """
    import jax.numpy as _jnp

    if hasattr(state, "active0"):
        n = (_jnp.sum(state.active0, axis=2)
             + _jnp.sum(state.active1, axis=2))          # (C, 2)
    else:
        n = _jnp.sum(state.active, axis=2)
    n = np.asarray(n, np.float64)
    v = np.asarray(state.box, np.float64) ** 3
    e = np.asarray(state.energy, np.float64)
    p = np.asarray(pressure_fd, np.float64)              # (C, 2)
    rho = n / v
    liq = rho.argmax(axis=1)
    ch = np.arange(n.shape[0])
    vap = 1 - liq
    n_l = np.maximum(n[ch, liq], 1.0)
    n_v = np.maximum(n[ch, vap], 1.0)
    du = e[ch, vap] / n_v - e[ch, liq] / n_l
    pv = p[ch, vap] * v[ch, vap] / n_v - p[ch, liq] * v[ch, liq] / n_l
    return du + pv
