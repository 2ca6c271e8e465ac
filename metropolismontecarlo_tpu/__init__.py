"""metropolismontecarlo_tpu — a data-parallel Metropolis Monte Carlo framework.

A from-scratch JAX/XLA re-design of the capabilities of
BradenDKelly/MetropolisMonteCarlo (serial Julia): NVT/NPT Metropolis MC of
monatomic Lennard-Jones fluids, rigid polyatomic LJ molecules, and rigid
water/polyatomics with bare-Coulomb / damped-Wolf / full-Ewald electrostatics.

Architecture (accelerator-first, not a port):
  * many independent MC chains are the vectorized axis (vmap within a
    device, sharded over a `jax.sharding.Mesh` across devices),
  * within a chain the move loop is a `lax.scan`,
  * per-move delta-energies are dense masked reductions that XLA fuses,
    instead of the reference's early-exit scalar loops,
  * Ewald reciprocal state (structure factors) is carried scan state with
    O(K) incremental updates, and
  * accept/reject is branchless `jnp.where` selection.

Reference layer map: see SURVEY.md at the repo root.
"""

__version__ = "0.1.0"

from metropolismontecarlo_tpu.utils import constants  # noqa: F401
