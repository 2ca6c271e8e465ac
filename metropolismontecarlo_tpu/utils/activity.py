"""Activity-mask slot updates as one-hot where-selects.

NEVER use a dynamic `.at[i].set(...)` scatter on the bool activity
mask inside the fused vmapped step scans: an XLA backend was caught
DROPPING such a scatter — the insertion's com write and energy delta
were applied while the activity bit silently stayed False, leaving a
phantom booked energy that surfaced as O(pair-energy) carried-vs-
recompute drift accumulating over exchanges.  A CPU replay of the
identical step (same threefry stream, same f32 state) disagreed with
the accelerator execution, isolating a backend miscompilation of the
bool-scatter + gather pattern in that fusion context; the isolated
pattern compiles correctly, so the trigger is fusion-dependent and the
only robust fix is to avoid the construct.  One-hot where-selects are
also the repo's stated design idiom ("accept/reject via jnp.where
selects only") and cost one masked vector op at slot capacities.
"""

import jax.numpy as jnp


def set_slot(active, i, on):
    """active[..., i] |= on (one-hot where; `on` scalar bool)."""
    return jnp.where(jnp.arange(active.shape[-1]) == i, on | active,
                     active)


def clear_slot(active, i, off):
    """active[..., i] &= ~off (one-hot where; `off` scalar bool)."""
    return jnp.where(jnp.arange(active.shape[-1]) == i, active & ~off,
                     active)


def _mask2(active, b, i):
    return (jnp.arange(active.shape[-2])[:, None] == b) \
        & (jnp.arange(active.shape[-1])[None, :] == i)


def set_slot2(active, b, i, on):
    """active[..., b, i] |= on for a (boxes, cap) activity mask."""
    return jnp.where(_mask2(active, b, i), on | active, active)


def clear_slot2(active, b, i, off):
    """active[..., b, i] &= ~off for a (boxes, cap) activity mask."""
    return jnp.where(_mask2(active, b, i), active & ~off, active)
