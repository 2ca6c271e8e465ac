"""Chain-parallel MC driver: vmapped move kernel, lax.scan sweeps, block
loop with drift-killing resync.

Re-design of the reference's `Loop` (`Ewald/main.jl:460-696`) and the
Poly/Monatomic drivers: C independent chains advance in lockstep; one
jitted `run_step` performs a full sweep (every molecule once) plus the
adaptive d_max update; `run_block` scans `n_steps` sweeps; the block
boundary recomputes total energies (chunked over chains to bound memory)
to both verify drift (reference `Poly/main.jl:232-235`) and resynchronize
the carried accumulators.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from metropolismontecarlo_tpu.mc.adjust import adjust_dmax
from metropolismontecarlo_tpu.mc.moves import make_sweep_fn
from metropolismontecarlo_tpu.mc.npt import make_volume_move_fn
from metropolismontecarlo_tpu.models.energy import energy_breakdown
from metropolismontecarlo_tpu.models.system import SimState
from metropolismontecarlo_tpu.ops import ewald as ewald_ops
from metropolismontecarlo_tpu.ops.quaternions import random_quaternion, rotate_vectors
from metropolismontecarlo_tpu.utils.chunking import chunked_vmap


def _auto_recompute_chunk(system, dtype, budget_bytes=2 << 30):
    """Chains per chunked-recompute step, from a peak-memory model.

    Dense path (<=4096 atoms, models/energy.py) peaks at a few (A, A)
    temporaries per chain; the row-tiled path at a few (256, A) tiles
    plus the (K, A) recip contraction.  ~4 live temporaries observed is
    the safety factor.  Clamped to [1, 64]: 64 already amortizes the
    scan overhead; larger only grows compile time."""
    A = system.n_atoms_padded
    item = jnp.dtype(dtype).itemsize
    if system.n_atoms > 4096:
        per_chain = 4 * (256 + 512) * A * item   # row tiles + recip K~512
    else:
        per_chain = 4 * A * A * item
    return int(max(1, min(64, budget_bytes // max(per_chain, 1))))


class MonteCarlo:
    """Bundles a System + RunParams into jitted chain-parallel MC kernels.

    Usage:
        mc = MonteCarlo(system, params, n_chains=1024)
        state = mc.init_state(jax.random.PRNGKey(0), com0, quat0, box0)
        state, metrics = mc.run_block(state, n_steps=100, adjust=True)
    """

    def __init__(self, system, params, dtype=jnp.float32,
                 recompute_chunk="auto", tp_mesh=None, pressure_ladder=None):
        """recompute_chunk: chains per step of the chunked full-energy
        recompute scan (drift checks, init, volume moves).  "auto"/None
        sizes it from a peak-memory model of the recompute path (dense
        O(A^2) below 4096 atoms, row-tiled O(256*A) above) against a
        fixed budget — small chunks bound memory but cost scan steps
        (init at 2048 chains with chunk 4 is a 512-step scan).

        tp_mesh: a 2-D ("chains", "atoms") Mesh (parallel.tp.make_mesh_2d)
        routes every full-energy recompute (drift check, resync,
        pressure) through the tensor-parallel row-sharded path — for
        single systems far beyond 10^4 atoms.  The sweep itself stays
        chain-local; chains must be divisible by the chains-axis size.

        pressure_ladder: (n_chains,) per-chain pressures for NPT —
        every chain samples its own isobar (one-run isotherm/EOS scans,
        the batch counterpart of per-chain state.temp ladders).
        Requires params.p_volume > 0; params.pressure may then be None.
        Gated by the per-chain ideal-gas closed form in tests/test_mc.py."""
        self.system = system
        self.params = params
        self.dtype = dtype
        if recompute_chunk in ("auto", None):
            recompute_chunk = _auto_recompute_chunk(system, dtype)
        self.recompute_chunk = recompute_chunk
        self.tp_mesh = tp_mesh
        self._tp_fe = None          # built lazily on first full_energy
        if params.coulomb == "ewald":
            self.kvecs, self.kweights = ewald_ops.make_kvectors(
                params.nk, params.ksq_max, strict=True
            )
        else:
            self.kvecs, self.kweights = None, None
        # one sweep body per species block (a single block for uniform
        # systems): each has static atom count/offset, so ragged mixtures
        # pay per-move work proportional to THAT species' size, never the
        # widest molecule's
        self._sweep_moves = tuple(
            (sl[1], sl[2],
             make_sweep_fn(system, params, self.kvecs, self.kweights,
                           dtype, species=sl))
            for sl in system.species_slices)
        if pressure_ladder is not None and params.p_volume <= 0.0:
            raise ValueError(
                "pressure_ladder requires params.p_volume > 0 — with no "
                "volume moves every chain would silently sample the same "
                "fixed-V NVT ensemble instead of its isobar")
        self._volume_move = (
            make_volume_move_fn(system, params, self.kvecs, self.kweights,
                                dtype, chunk=self.recompute_chunk,
                                build_coords=self.build_coords,
                                pressure=pressure_ladder)
            if (params.pressure is not None or pressure_ladder is not None)
            and params.p_volume > 0.0
            else None
        )

    def _check_min_image(self, box):
        """r_cut <= box/2 or pair energies silently miss second images
        (reference asserts this, `Ewald/main.jl:483-485`; equality is
        allowed — the NIST configs use r_cut = box/2 exactly).  Under
        NPT the volume move enforces the same wall on sampled boxes.
        params.strict_min_image=False downgrades to a warning (the
        truncated-nearest-image model is still self-consistent)."""
        max_cut = float(max(self.params.r_cut, self.params.qq_cut))
        bmin = float(jnp.min(box))
        if bmin + 1e-6 < 2.0 * max_cut:
            msg = (f"minimum image violated: box {bmin:.4f} < 2 * cutoff "
                   f"{max_cut} — enlarge the system or shrink "
                   f"r_cut/qq_r_cut (or set strict_min_image=False to "
                   f"sample the truncated-nearest-image model)")
            if self.params.strict_min_image:
                raise ValueError(msg)
            import warnings
            warnings.warn(msg, stacklevel=3)

    # ---------------- state construction ----------------

    def build_coords(self, com, quat):
        """Atoms from molecular COM + orientation: r = com + R(q) b.
        com (..., M, 3), quat (..., M, 4) -> (..., 3, A_pad): transposed
        atoms-on-lanes layout with zero-filled lane padding (see
        SimState/System.n_atoms_padded).  Ragged systems gather only the
        real atom slots of each molecule."""
        body = jnp.asarray(self.system.body, self.dtype)
        atoms = com[..., :, None, :] + rotate_vectors(quat, body)
        if self.system.uniform_width:
            flat = atoms.reshape(atoms.shape[:-3] + (self.system.n_atoms, 3))
        else:
            mol, slot = self.system.atom_mol_slot
            flat = atoms[..., mol, slot, :]
        out = jnp.swapaxes(flat, -1, -2)
        pad = self.system.n_atoms_padded - self.system.n_atoms
        if pad:
            out = jnp.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, pad)])
        return out

    def init_state(self, key, com, quat=None, box=None, n_chains=None,
                   perturb_key=None):
        """Create a SimState.  com (M,3) or (C,M,3); quat likewise or None
        (random orientations); box scalar or (C,)."""
        M = self.system.n_mol
        com = jnp.asarray(com, self.dtype)
        if com.ndim == 2:
            if n_chains is None:
                raise ValueError("n_chains required when replicating one config")
            com = jnp.broadcast_to(com[None], (n_chains, M, 3))
        C = com.shape[0]
        if quat is None:
            quat = random_quaternion(key, (C, M), dtype=self.dtype)
        else:
            quat = jnp.asarray(quat, self.dtype)
            if quat.ndim == 2:
                quat = jnp.broadcast_to(quat[None], (C, M, 4))
        box = jnp.asarray(box, self.dtype)
        box = jnp.broadcast_to(jnp.atleast_1d(box), (C,))
        self._check_min_image(box)
        coords = self.build_coords(com, quat)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(C))
        p = self.params
        state = SimState(
            com=com, quat=quat, coords=coords, box=box,
            sfac=jnp.zeros((C, 1, 2), self.dtype),
            energy=jnp.zeros((C,), self.dtype),
            virial=jnp.zeros((C,), self.dtype),
            key=keys, temp=jnp.full((C,), p.temperature, self.dtype),
            step=jnp.zeros((), jnp.int32),
            dr_max=jnp.full((C,), p.dr_max, self.dtype),
            dphi_max=jnp.full((C,), p.dphi_max, self.dtype),
            dv_max=jnp.full((C,), p.dv_max, self.dtype),
            acc=jnp.zeros((C, 3), jnp.int32),
            att=jnp.zeros((C, 3), jnp.int32),
            nbr=self._init_nbr(C),
            nbr_needed=jnp.zeros((C,), jnp.int32),
        )
        return self.resync(state)

    def init_from_coords(self, key, coords, com, box, n_chains):
        """Replicate one explicit atom configuration (e.g. a NIST sample)
        across chains.  Per-molecule quaternions are recovered from the
        actual geometry by a Kabsch fit against the body template, and the
        atoms are rebuilt as com + R(q) body so that state and move kernel
        agree exactly (exact for rigid configurations)."""
        from metropolismontecarlo_tpu.ops.quaternions import fit_quaternions

        M = self.system.n_mol
        C = n_chains
        coords_np = np.asarray(coords, np.float64).reshape(
            self.system.n_atoms, 3)
        com_np = np.asarray(com, np.float64)
        box_np = float(np.asarray(box).reshape(-1)[0])
        body_np = np.asarray(self.system.body, np.float64)
        quat_np = np.zeros((M, 4))
        for _, m0, m1, p, a0 in self.system.species_slices:
            c = coords_np[a0:a0 + (m1 - m0) * p].reshape(m1 - m0, p, 3)
            rel = c - com_np[m0:m1, None, :]
            rel -= box_np * np.round(rel / box_np)  # heal PBC-split molecules
            quat_np[m0:m1] = fit_quaternions(body_np[m0:m1, :p], rel)
        com = jnp.broadcast_to(jnp.asarray(com_np, self.dtype)[None], (C, M, 3))
        quat = jnp.broadcast_to(jnp.asarray(quat_np, self.dtype)[None], (C, M, 4))
        self._check_min_image(jnp.asarray(box_np))
        coords = self.build_coords(com, quat)
        box = jnp.broadcast_to(jnp.asarray(box, self.dtype)[None], (C,))
        keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(C))
        p = self.params
        state = SimState(
            com=com, quat=quat, coords=coords, box=box,
            sfac=jnp.zeros((C, 1, 2), self.dtype),
            energy=jnp.zeros((C,), self.dtype),
            virial=jnp.zeros((C,), self.dtype),
            key=keys, temp=jnp.full((C,), p.temperature, self.dtype),
            step=jnp.zeros((), jnp.int32),
            dr_max=jnp.full((C,), p.dr_max, self.dtype),
            dphi_max=jnp.full((C,), p.dphi_max, self.dtype),
            dv_max=jnp.full((C,), p.dv_max, self.dtype),
            acc=jnp.zeros((C, 3), jnp.int32),
            att=jnp.zeros((C, 3), jnp.int32),
            nbr=self._init_nbr(C),
            nbr_needed=jnp.zeros((C,), jnp.int32),
        )
        return self.resync(state)

    def _init_nbr(self, n_chains):
        """Neighbor-list buffer; content is rebuilt at every sweep start."""
        nb = self.params.nlist_width
        if nb <= 0:
            return jnp.zeros((n_chains, 1, 1), jnp.int32)
        return jnp.zeros((n_chains, self.system.n_mol, nb), jnp.int32)

    # ---------------- full recompute / resync ----------------

    @functools.partial(jax.jit, static_argnums=0)
    def full_energy(self, state):
        """Chunked full-system energy over chains: (C,) totals, virials,
        and (C, K, 2) structure factors.  With tp_mesh set, the pair
        tiles and recip contractions are sharded over the atoms axis."""
        A = self.system.n_atoms
        if self.tp_mesh is not None:
            from metropolismontecarlo_tpu.parallel.tp import tp_full_energy_fn
            if self._tp_fe is None:
                self._tp_fe = tp_full_energy_fn(
                    self.system, self.params, self.tp_mesh,
                    self.kvecs, self.kweights,
                    recompute_chunk=self.recompute_chunk)
            return self._tp_fe(state.coords, state.com, state.box)

        def one(coords_t, com, box):
            out = energy_breakdown(self.system, self.params,
                                   coords_t[:, :A].T, com, box,
                                   self.kvecs, self.kweights)
            return out["total"], out["w"], out["sfac"]

        return chunked_vmap(one, self.recompute_chunk, state.coords,
                            state.com, state.box)

    def resync(self, state):
        """Replace accumulated energy/virial/sfac with freshly recomputed
        values; returns the corrected state."""
        e, w, sfac = self.full_energy(state)
        if self.params.coulomb != "ewald":
            sfac = state.sfac
        return state._replace(energy=e, virial=w, sfac=sfac)

    # ---------------- sweeps ----------------

    def sweep(self, state):
        """One sweep: every molecule attempted once (reference
        `Ewald/main.jl:490`), plus an NPT volume-move attempt if enabled."""
        if self.params.nlist_width > 0:
            from metropolismontecarlo_tpu.mc.moves import (
                nlist_radius,
                rebuild_nlist,
            )
            nbr, needed = rebuild_nlist(
                state.com, state.box, self.params,
                nlist_radius(self.system, self.params))
            # running max of required width, checked at block boundaries
            state = state._replace(
                nbr=nbr, nbr_needed=jnp.maximum(state.nbr_needed, needed))
        for m0, m1, sweep_body in self._sweep_moves:
            state, _ = jax.lax.scan(sweep_body, state, jnp.arange(m0, m1))
        if self._volume_move is not None:
            # deterministic volume-attempt cycle (see mc/npt.py docstring):
            # all chains attempt every round(1/p_volume) sweeps; lax.cond
            # skips the O(A^2) recompute entirely on the other sweeps.
            # step is a pure molecule-move counter so step // n_mol is the
            # exact 1-based sweep index at this point in the sweep.
            period = max(1, int(round(1.0 / self.params.p_volume)))
            if period == 1:
                state = self._volume_move(state)
            else:
                sweep_idx = state.step // self.system.n_mol
                state = jax.lax.cond(sweep_idx % period == 0,
                                     self._volume_move, lambda s: s, state)
        return state

    @functools.partial(jax.jit, static_argnums=(0, 2, 3))
    def run_steps(self, state, n_steps, adjust=False):
        """n_steps sweeps; optionally adapt d_max between sweeps toward the
        target acceptance (reference `Ewald/main.jl:645-651`)."""

        def step(state, _):
            state = self.sweep(state)
            if adjust:
                p = self.params
                # list exactness requires dr_max <= nlist_skin/2 (proposals
                # are +-dr_max/2 per axis; see RunParams.nlist_width) — cap
                # the controller so it cannot silently stale the lists
                dr_hi = state.box / 2.0 if p.nlist_width <= 0 else \
                    jnp.minimum(state.box / 2.0, p.nlist_skin / 2.0)
                dr = adjust_dmax(state.dr_max, state.acc[:, 0], state.att[:, 0],
                                 p.move_accept, dr_hi)
                dphi = adjust_dmax(state.dphi_max, state.acc[:, 1], state.att[:, 1],
                                   p.move_accept, jnp.pi)
                dv = adjust_dmax(state.dv_max, state.acc[:, 2], state.att[:, 2],
                                 p.move_accept, jnp.asarray(1.0, state.dv_max.dtype))
                state = state._replace(
                    dr_max=dr, dphi_max=dphi, dv_max=dv,
                    acc=jnp.zeros_like(state.acc), att=jnp.zeros_like(state.att),
                )
            return state, None

        state, _ = jax.lax.scan(step, state, None, length=n_steps)
        return state

    @functools.partial(jax.jit, static_argnums=(0,), static_argnames=("rel_eps",))
    def pressure_fd(self, state, rel_eps=1e-4):
        """Exact pressure observable via central finite difference of the
        total energy under isotropic molecular (COM) scaling:

            P = M T / V  -  dU/dV|_{rigid}

        This differentiates the SAME energy function the simulation
        samples (including the kappa = 5.6/box convention).  Since round
        2 the closed-form molecular virial (energy_breakdown "w", carried
        in state.virial) gives the same pressure analytically at no extra
        cost — this FD route is kept as the independent cross-check of
        that derivation.  Costs two chunked full recomputes.  Returns
        (C,) pressures in K/A^3.
        """
        A = self.system.n_atoms

        def energy_at(scale, st):
            box = st.box * scale
            com = st.com * scale
            coords_t = self.build_coords(com, st.quat)

            def one(crd_t, cm, bx):
                out = energy_breakdown(self.system, self.params,
                                       crd_t[:, :A].T, cm, bx,
                                       self.kvecs, self.kweights)
                return out["total"]

            return chunked_vmap(one, self.recompute_chunk, coords_t, com, box)

        eps = jnp.asarray(rel_eps, self.dtype)
        sp = (1.0 + eps) ** (1.0 / 3.0)
        sm = (1.0 - eps) ** (1.0 / 3.0)
        vol = state.box**3
        du_dv = (energy_at(sp, state) - energy_at(sm, state)) / (2.0 * eps * vol)
        return self.system.n_mol * state.temp / vol - du_dv

    def widom(self, state, key, n_insertions=64, species=0):
        """Widom test-particle insertion (beyond-parity observable; see
        mc/widom.py): samples n_insertions uniform ghost poses of the
        given species per chain and returns a dict with

          boltzmann_mean (C,): <exp(-beta dU)> over this sample — the
              quantity to average over a production run (arithmetic mean
              over samples AND chains at equal temperature), then pass
              to mu_excess;
          mu_ex (C,): -kT ln of THIS sample's mean (diagnostic only;
              the log of a noisy mean is biased — average the factors).

        The evaluator is jit-compiled per species on first use.
        """
        fns = getattr(self, "_widom_fns", None)
        if fns is None:
            fns = self._widom_fns = {}
        entry = fns.get(species)
        if entry is None:
            from metropolismontecarlo_tpu.mc.widom import make_widom_fn
            _, sample = make_widom_fn(
                self.system, self.params, self.kvecs, self.kweights,
                dtype=self.dtype, species=species,
                chunk=self.recompute_chunk)
            entry = fns[species] = jax.jit(sample, static_argnums=2)
        b = entry(state, key, int(n_insertions))
        from metropolismontecarlo_tpu.mc.widom import mu_excess
        return {"boltzmann_mean": b, "mu_ex": mu_excess(b, state.temp)}

    def quench(self, state, n_steps=20, temp=1e-6):
        """Orientation/position descent: run sweeps at a near-zero
        temperature so only downhill moves are accepted — the vectorized
        equivalent of the reference's trial-rotation `EnergyMinimize`
        (`Ewald/energy.jl:464-507`).  Restores the original temperatures."""
        t0 = state.temp
        state = state._replace(temp=jnp.full_like(state.temp, temp))
        state = self.run_steps(state, n_steps, False)
        return self.resync(state._replace(temp=t0))

    # ---------------- blocks ----------------

    def run_block(self, state, n_steps, adjust=False, drift_tol=None):
        """One block: n_steps sweeps, then recompute-vs-accumulated drift
        check and resync.  Returns (state, metrics dict of host floats)."""
        acc0, att0 = state.acc, state.att
        state = self.run_steps(state, n_steps, adjust)
        e, w, sfac = self.full_energy(state)
        drift = jnp.max(jnp.abs(e - state.energy) / jnp.maximum(jnp.abs(e), 1.0))
        if self.params.nlist_width > 0:
            needed = int(jnp.max(state.nbr_needed))
            if needed > self.params.nlist_width:
                raise RuntimeError(
                    f"neighbor-list overflow: up to {needed} molecules fell "
                    f"within the list radius during this block but "
                    f"nlist_width={self.params.nlist_width}; increase it")
        metrics = {
            "energy_mean": float(jnp.mean(e)),
            "energy_min": float(jnp.min(e)),
            "energy_max": float(jnp.max(e)),
            "virial_mean": float(jnp.mean(w)),
            "drift_max_rel": float(drift),
            "dr_max_mean": float(jnp.mean(state.dr_max)),
            "dphi_max_mean": float(jnp.mean(state.dphi_max)),
        }
        if not adjust:
            d_att = state.att - att0
            d_acc = state.acc - acc0
            ratio = d_acc / jnp.maximum(d_att, 1)
            metrics["acc_trans"] = float(jnp.mean(ratio[:, 0]))
            metrics["acc_rot"] = float(jnp.mean(ratio[:, 1]))
            metrics["acc_vol"] = float(jnp.mean(ratio[:, 2]))
        if self.params.coulomb != "ewald":
            sfac = state.sfac
        state = state._replace(energy=e, virial=w, sfac=sfac)
        if drift_tol is not None and metrics["drift_max_rel"] > drift_tol:
            raise RuntimeError(
                f"energy drift {metrics['drift_max_rel']:.3e} exceeds {drift_tol}"
            )
        return state, metrics
