"""System description and simulation state.

The reference holds its state in mutable StructArrays (`soa`/`moa`,
`Ewald/structs.jl:283-321`) updated in place.  The data-parallel design splits
that into:

* `System` — static structure & force field (shapes, body frames, charge/
  type tables).  A plain frozen dataclass of host arrays; jitted programs
  close over it, so its contents are compile-time constants.
* `RunParams` — static run configuration (temperature, cutoffs, move
  probabilities, Coulomb style...).  Honors the reference's own TODO of a
  real config layer (`Ewald/main.jl:49`).
* `SimState` — the per-chain dynamic state threaded through `lax.scan`:
  every field has a leading chains axis `C` and the whole thing is a
  pytree (NamedTuple), so accept/reject is `jnp.where` selection and
  checkpointing is one tree flatten.

Molecules are uniform-width: every molecule has `P` atom slots; mixed
species (e.g. TIP3P water + MEA) pad smaller molecules with slots of zero
mass, zero charge, and a zero-epsilon LJ type, which contribute exactly
zero energy without any masking in the kernels.
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True, eq=False)
class System:
    """Static structure + force field (host arrays, closed over by jit).

    `eq=False` keeps identity hashing so a System instance can be a
    static jit argument.

    Reference analogue: FFParameters/Tables/soa/moa construction in
    `Ewald/setup.jl:446-673`.

    Mixed species use RAGGED species-blocked storage: `species` lists
    contiguous blocks of identical molecules as (name, count, p) tuples
    (molecule order must match).  Per-molecule arrays stay padded to the
    widest species (atoms_per_mol = P_max) for shape regularity, but the
    ATOM axis is ragged — molecule m owns mol_p[m] atom columns starting
    at mol_a0[m], so a 3-atom water next to an 11-atom MEA costs 3
    columns, not 11.  species=None means one uniform-width block.
    """

    n_mol: int                 # M
    atoms_per_mol: int         # P_max (per-molecule array width)
    body: np.ndarray           # (M, P, 3) body-fixed coords (COM at origin)
    masses: np.ndarray         # (M, P); 0.0 marks padding slots
    charges: np.ndarray        # (M, P)
    type_ids: np.ndarray       # (M, P) int32 LJ-type index
    eps_table: np.ndarray      # (T, T) epsilon_ij in K (pre-mixed)
    sig_table: np.ndarray      # (T, T) sigma_ij in Angstrom
    name: str = "system"
    species: Optional[tuple] = None   # ((name, count, p), ...) or None

    def __post_init__(self):
        # Systems are shared freely (lru_cached constructors, tests that
        # alias one System's arrays into another), so any in-place write
        # to a field array corrupts every holder.  Freeze them: NumPy
        # raises at the exact mutating line instead of silently leaking
        # state across tests/runs.
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                v.setflags(write=False)

    @property
    def species_slices(self):
        """((name, m0, m1, p, a0), ...): molecule range [m0, m1), atoms
        per molecule p, and first atom column a0 of each species block."""
        if self.species is None:
            return (("all", 0, self.n_mol, self.atoms_per_mol, 0),)
        out, m0, a0 = [], 0, 0
        for name, count, p in self.species:
            out.append((name, m0, m0 + count, p, a0))
            m0 += count
            a0 += count * p
        assert m0 == self.n_mol, "species counts disagree with n_mol"
        return tuple(out)

    @property
    def mol_p(self):
        """(M,) true atoms per molecule."""
        out = np.empty(self.n_mol, np.int32)
        for _, m0, m1, p, _ in self.species_slices:
            out[m0:m1] = p
        return out

    @property
    def mol_a0(self):
        """(M,) first atom column of each molecule."""
        p = self.mol_p
        return np.concatenate([[0], np.cumsum(p)[:-1]]).astype(np.int32)

    @property
    def uniform_width(self):
        """True when every molecule has atoms_per_mol atom columns (the
        fast reshape layout; ragged systems gather instead)."""
        return self.species is None or all(
            p == self.atoms_per_mol for _, _, p in self.species)

    @property
    def n_atoms(self):
        if self.species is None:
            return self.n_mol * self.atoms_per_mol
        return int(sum(count * p for _, count, p in self.species))

    @property
    def n_atoms_padded(self):
        """Atom-axis storage width: n_atoms rounded up to a multiple of
        128 (256 from 256 atoms on), so the pair grids have a fixed,
        aligned width.  Pad columns hold dummy atoms (molecule id -1, zero
        charge, pad LJ type) that every kernel excludes by mask."""
        gran = 256 if self.n_atoms >= 256 else 128
        return -(-self.n_atoms // gran) * gran

    @property
    def atom_mol_slot(self):
        """((A,) molecule index, (A,) slot-within-molecule index): the
        gather map from (M, P_max) padded arrays to the ragged atom axis."""
        mol = np.repeat(np.arange(self.n_mol, dtype=np.int32), self.mol_p)
        slot = np.arange(self.n_atoms, dtype=np.int32) \
            - np.repeat(self.mol_a0, self.mol_p)
        return mol, slot

    @property
    def mol_of_atom_padded(self):
        """(A_pad,) molecule index per atom column; -1 marks padding."""
        out = np.full(self.n_atoms_padded, -1, np.int32)
        out[: self.n_atoms] = self.atom_mol_slot[0]
        return out

    @property
    def is_uniform(self):
        """True when every molecule shares one body/charge/type pattern
        (required by the molecular open-ensemble apps).  Ragged mixtures are instead PER-SPECIES uniform — see
        species_slices."""
        if not self.uniform_width:
            return False
        t = np.asarray(self.type_ids)
        q = np.asarray(self.charges)
        b = np.asarray(self.body)
        return bool((t == t[0]).all() and (q == q[0]).all()
                    and np.allclose(b, b[0]))

    @property
    def species_uniform(self):
        """True when every species block is internally uniform (one
        body/charge/type template per block) — required by the
        multi-species open-ensemble apps.  Uniform single-species systems trivially qualify;
        blocks built by models.from_topology always do (one template
        per species)."""
        t = np.asarray(self.type_ids)
        q = np.asarray(self.charges)
        b = np.asarray(self.body)
        for _, m0, m1, p, _ in self.species_slices:
            if not ((t[m0:m1, :p] == t[m0, :p]).all()
                    and (q[m0:m1, :p] == q[m0, :p]).all()
                    and np.allclose(b[m0:m1, :p], b[m0, :p])):
                return False
        return True

    @property
    def tid_row_padded(self):
        """(A_pad,) per-atom LJ type id; -1 marks padding."""
        out = np.full(self.n_atoms_padded, -1, np.int64)
        out[: self.n_atoms] = self.flat(self.type_ids)
        return out

    @property
    def type_counts(self):
        t = np.zeros(self.eps_table.shape[0])
        np.add.at(t, self.flat(np.asarray(self.type_ids)), 1.0)
        return t

    def flat(self, arr):
        """(M, P_max, ...) -> (A, ...): drop per-molecule padding slots.
        Works on host numpy and traced jnp arrays alike."""
        if self.uniform_width:
            return arr.reshape((self.n_atoms,) + arr.shape[2:])
        mol, slot = self.atom_mol_slot
        return arr[mol, slot]


@dataclasses.dataclass(frozen=True)
class RunParams:
    """Static run configuration (compile-time constants)."""

    temperature: float = 298.15       # K (or reduced units)
    r_cut: float = 10.0               # LJ cutoff, Angstrom
    qq_r_cut: Optional[float] = None  # real-space Coulomb cutoff (default r_cut)
    cutoff_mode: str = "site"         # "site" | "com" | "first" (see ops.pairs)
    lj_shift: str = "none"            # "none" | "linear" (ops.lj)
    use_lrc: bool = True              # LJ tail corrections
    coulomb: str = "none"             # "none" | "ewald" | "wolf" | "bare"
    # Wolf flavor: "pairwise" = standard Wolf et al. (1999) pairwise-
    # shifted form; "ref" = the reference's convention (plain erfc pair
    # sum + global -Q^2 erfc(k rc)/rc constant, `Ewald/energy.jl:924-934`)
    # for number-for-number energy comparison.
    wolf_style: str = "pairwise"
    # Ewald surface (dipole) term, removing the tinfoil-boundary
    # assumption: + factor 2pi/(3V) |sum_i q_i r_i|^2 (vacuum epsilon'=1;
    # the reference's written-but-disabled `TinfoilBoundary`,
    # `Ewald/ewalds.jl:835-844`).
    ewald_surface: bool = False
    kappa_L: float = 5.6              # Ewald/Wolf damping: kappa = kappa_L / box
    nk: int = 5                       # Ewald k-space range
    ksq_max: int = 27                 # 0 < |k|^2 < ksq_max (integer units)
    p_translate: float = 0.5          # move-type probability (rest: rotation)
    dr_max: float = 0.3               # initial max displacement, Angstrom
    dphi_max: float = 0.05            # initial max rotation angle, rad
    move_accept: float = 0.5          # adaptive-step target acceptance
    d2_overlap: float = 0.5           # hard-overlap veto distance^2
    # NPT (pressure in K/Angstrom^3 i.e. P/kB; NVT if pressure is None)
    pressure: Optional[float] = None
    p_volume: float = 0.0             # volume-attempt rate: every chain
    #   attempts one volume move every round(1/p_volume) sweeps
    #   (deterministic cycle, see mc/npt.py; 0 = never)
    dv_max: float = 0.05              # max fractional ln-volume step
    # molecule-level Verlet neighbor lists (EXPERIMENTAL, jnp path only):
    # nlist_width = max neighbor molecules kept per molecule (0 = off);
    # lists rebuild every sweep with radius max(r_cut, qq_cut) +
    # nlist_skin + 2*max-atom-to-COM-distance; exact while
    # dr_max <= nlist_skin/2, and overflow is detected at block
    # boundaries.  Per-chain dynamic gathers trade the dense scan's
    # regular memory access for fewer pairs; whether that pays on a
    # given device is a measurement, not an assumption.
    nlist_width: int = 0
    nlist_skin: float = 2.0

    # Minimum-image discipline (reference asserts r_cut <= box/2 at
    # startup, `Ewald/main.jl:483-485`).  True: init raises if violated
    # and the NPT volume move hard-walls boxes below 2*cutoff — sampled
    # physics always sees valid nearest images.  False: sample the
    # truncated-nearest-image model as-is (self-consistent, but misses
    # second-image interactions; used by small test systems).
    strict_min_image: bool = True

    @property
    def qq_cut(self):
        return self.r_cut if self.qq_r_cut is None else self.qq_r_cut


class SimState(NamedTuple):
    """Per-chain dynamic MC state (all fields lead with the chains axis C)."""

    com: jnp.ndarray        # (C, M, 3) molecular centers of mass
    quat: jnp.ndarray       # (C, M, 4) orientations
    coords: jnp.ndarray     # (C, 3, A) atom positions, TRANSPOSED layout:
                            #   atoms on the minor (contiguous) axis so
                            #   dense pair grids read coalesced rows
                            #   (A = n_atoms_padded)
    box: jnp.ndarray        # (C,) box edge length
    sfac: jnp.ndarray       # (C, K, 2) Ewald structure factors ([re, im]); (C,1,2) dummy otherwise
    energy: jnp.ndarray     # (C,) running total potential energy (K)
    virial: jnp.ndarray     # (C,) running molecular virial sum(rij.fij)
    key: jnp.ndarray        # (C, 2) uint32 per-chain RNG keys
    temp: jnp.ndarray       # (C,) per-chain temperature (REMC ladders, annealing)
    step: jnp.ndarray       # () int32 global move counter (RNG stream position)
    dr_max: jnp.ndarray     # (C,) adaptive max translation
    dphi_max: jnp.ndarray   # (C,) adaptive max rotation
    dv_max: jnp.ndarray     # (C,) adaptive max volume step
    acc: jnp.ndarray        # (C, 3) int32 accepted [trans, rot, vol] since adjust
    att: jnp.ndarray        # (C, 3) int32 attempted [trans, rot, vol] since adjust
    nbr: jnp.ndarray        # (C, M, NB) int32 neighbor-molecule lists
                            #   (self-index padded; (C,1,1) dummy when off)
    nbr_needed: jnp.ndarray  # (C,) int32 running max molecules within the
                            #   list radius (overflow detection)
