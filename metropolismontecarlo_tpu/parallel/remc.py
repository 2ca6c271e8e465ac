"""Replica-exchange Monte Carlo (parallel tempering) across the chain axis.

The reference lists REMC as an unimplemented TODO (`Ewald/main.jl:55`,
`Ewald/readme.md:16`); here it is the framework's multi-device
communication showcase: replicas live along the sharded chains axis, and
the partner gathers lower to collective-permutes when neighbours
straddle device boundaries.

Ladder layout: chain c holds temperature T_c (SimState.temp).  An
exchange round proposes swaps of CONFIGURATIONS between adjacent chains
(even phase: pairs (0,1),(2,3),...; odd phase: (1,2),(3,4),...), accepted
with

  P_acc = min(1, exp((1/T_i - 1/T_j)(E_i - E_j)))

Both partners draw the SAME decision (randomness keyed on the pair id),
so the swap is symmetric and collective-free in logic — only the state
exchange itself communicates.
"""

import jax
import jax.numpy as jnp

_SWAP_FIELDS = ("com", "quat", "coords", "box", "sfac", "energy", "virial")


def temperature_ladder(t_min, t_max, n, kind="geometric", dtype=jnp.float32):
    """Standard geometric (or linear) replica ladder."""
    if kind == "geometric":
        return jnp.asarray(
            t_min * (t_max / t_min) ** (jnp.arange(n) / max(n - 1, 1)), dtype
        )
    return jnp.linspace(t_min, t_max, n, dtype=dtype)


def exchange(state, key, phase):
    """One replica-exchange round over SimState.

    key: scalar PRNG key for this round (host-supplied, shared by all
    chains).  phase: 0 (even pairs) or 1 (odd pairs).  Temperatures stay
    attached to chain slots; configurations (and their energies, virials,
    structure factors) swap.  Adaptive step sizes travel WITH the
    temperature slot (they are tuned per temperature, not per config).
    Returns (state, swap_fraction).
    """
    C = state.temp.shape[0]
    c = jnp.arange(C)
    # partner pairing within this phase; self-partner at the edges
    base = c - ((c - phase) % 2 * 2 - 1)
    partner = jnp.clip(jnp.where((base >= 0) & (base < C), base, c), 0, C - 1)
    active = partner != c

    e_p = jnp.take(state.energy, partner, axis=0)
    t_p = jnp.take(state.temp, partner, axis=0)
    arg = (1.0 / state.temp - 1.0 / t_p) * (state.energy - e_p)

    # identical draw for both members of a pair: key folded with pair id
    pair_id = jnp.minimum(c, partner)
    u = jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(key, i)))(pair_id)
    swap = active & ((arg > 0.0) | (u < jnp.exp(jnp.minimum(arg, 0.0))))

    def take_partner(x):
        xp = jnp.take(x, partner, axis=0)
        s = swap.reshape((C,) + (1,) * (x.ndim - 1))
        return jnp.where(s, xp, x)

    state = state._replace(
        **{f: take_partner(getattr(state, f)) for f in _SWAP_FIELDS})
    swap_fraction = jnp.sum(swap) / jnp.maximum(jnp.sum(active), 1)
    return state, swap_fraction


def exchange_shardlocal(state, key, phase, n_devices, axis_name="chains"):
    """`exchange`, shard-local: the body to call INSIDE shard_map when the
    chain axis is sharded over `n_devices` contiguous blocks.

    Partner values for the two boundary chains of each local block come
    from explicit `jax.lax.ppermute` edge swaps over the device ring;
    everything else is local.  Matches the
    unsharded `exchange` bitwise: same global pair ids, same fold_in
    draws, same accept rule (tests/test_parallel.py).

    state: the LOCAL shard of a SimState (leading axis L = C/n_devices).
    Returns (state, swap_fraction) with the GLOBAL swap fraction (psum).
    """
    L = state.temp.shape[0]
    C = n_devices * L
    d = jax.lax.axis_index(axis_name)
    c = d * L + jnp.arange(L)                    # global chain ids
    base = c - ((c - phase) % 2 * 2 - 1)
    partner = jnp.clip(jnp.where((base >= 0) & (base < C), base, c), 0, C - 1)
    active = partner != c
    up = partner > c                             # partner is chain c+1

    perm_up = [(i, (i - 1) % n_devices) for i in range(n_devices)]
    perm_dn = [(i, (i + 1) % n_devices) for i in range(n_devices)]

    def partner_vals(x):
        # next device's first row / previous device's last row via ppermute
        nxt = jax.lax.ppermute(x[:1], axis_name, perm_up)
        prv = jax.lax.ppermute(x[-1:], axis_name, perm_dn)
        x_up = jnp.concatenate([x[1:], nxt], axis=0)
        x_dn = jnp.concatenate([prv, x[:-1]], axis=0)
        s = up.reshape((L,) + (1,) * (x.ndim - 1))
        return jnp.where(s, x_up, x_dn)

    e_p = partner_vals(state.energy)
    t_p = partner_vals(state.temp)
    arg = (1.0 / state.temp - 1.0 / t_p) * (state.energy - e_p)
    pair_id = jnp.minimum(c, partner)
    u = jax.vmap(
        lambda i: jax.random.uniform(jax.random.fold_in(key, i)))(pair_id)
    swap = active & ((arg > 0.0) | (u < jnp.exp(jnp.minimum(arg, 0.0))))

    def take_partner(x):
        s = swap.reshape((L,) + (1,) * (x.ndim - 1))
        return jnp.where(s, partner_vals(x), x)

    state = state._replace(
        **{f: take_partner(getattr(state, f)) for f in _SWAP_FIELDS})
    n_swap = jax.lax.psum(jnp.sum(swap), axis_name)
    n_act = jax.lax.psum(jnp.sum(active), axis_name)
    return state, n_swap / jnp.maximum(n_act, 1)
