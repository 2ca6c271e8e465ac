"""Tensor parallelism for very large systems: shard the ATOM dimension.

Chain parallelism (parallel.mesh) scales throughput; for single systems
far beyond 10^4 atoms the expensive objects are the O(A^2) pair-tile
scan and the O(K*A) reciprocal contractions of the FULL-energy
recompute (drift check, resync, pressure, NPT trial energies).  This
module splits exactly that work over a second mesh axis:

* 2-D `Mesh` over ("chains", "atoms"): chains shard as before, and each
  chain's recompute row-blocks + S(k)/recip-virial contractions split
  over the atoms axis with `psum` partial reductions over the
  interconnect (models.energy._energy_breakdown_tiled row_shard mode).
* The per-move sweep stays chain-local BY DESIGN: a per-move psum would
  serialize on interconnect latency every move.

The reference has no counterpart (serial Julia; its scaling TODO is the
neighbor list, `Ewald/readme.md:21`) — this is the SURVEY section-2.2
"shard the (K, A) recip matmul / pair tiles" item.

Works on multi-device hosts and on the CPU virtual-device mesh used in
tests; results match the unsharded recompute to roundoff.
"""

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from metropolismontecarlo_tpu.models.energy import _energy_breakdown_tiled
from metropolismontecarlo_tpu.parallel.mesh import CHAINS
from metropolismontecarlo_tpu.utils.chunking import chunked_vmap

ATOMS = "atoms"


def make_mesh_2d(n_chain_shards, n_atom_shards, devices=None):
    """(chains x atoms) mesh.  Adjacent devices share the atoms axis so
    the per-recompute psums stay between neighbours.  Raises when the
    backend has fewer devices than the mesh needs (never substitutes
    another platform's devices)."""
    if devices is None:
        devices = jax.devices()
    need = n_chain_shards * n_atom_shards
    if len(devices) < need:
        raise ValueError(
            f"a {n_chain_shards}x{n_atom_shards} mesh needs {need} devices; "
            f"the {jax.default_backend()} backend has {len(devices)}")
    devices = np.asarray(devices[:need]).reshape(
        n_chain_shards, n_atom_shards)
    return Mesh(devices, (CHAINS, ATOMS))


def tp_full_energy_fn(system, params, mesh, kvecs=None, kweights=None,
                      recompute_chunk=1, row_block=256):
    """Build f(coords (C,3,A_pad), com (C,M,3), box (C,)) -> (e, w, sfac)
    with chains sharded over mesh axis "chains" and each chain's pair /
    recip work sharded over "atoms".  C must be divisible by
    n_chain_shards * recompute_chunk.  Drop-in replacement for
    MonteCarlo.full_energy on a 2-D mesh."""
    n_tp = mesh.shape[ATOMS]
    A = system.n_atoms

    def one(coords_t, com, box):
        out = _energy_breakdown_tiled(
            system, params, coords_t[:, :A].T, com, box, kvecs, kweights,
            row_block=row_block, row_shard=(ATOMS, n_tp))
        return out["total"], out["w"], out["sfac"]

    def local(coords, com, box):
        return chunked_vmap(one, recompute_chunk, coords, com, box)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(CHAINS), P(CHAINS), P(CHAINS)),
        out_specs=(P(CHAINS), P(CHAINS), P(CHAINS)),
        check_vma=False)
