"""Device-mesh scale-out for chain-parallel MC.

The reference is a serial single-process code (SURVEY.md section 2.2); the
scaling story here is data parallelism over independent chains:

* a 1-D `jax.sharding.Mesh` over the "chains" axis,
* every SimState field with a leading C axis sharded over it,
* the move/sweep kernels are chain-local, so the hot loop runs with ZERO
  cross-device traffic — XLA propagates the sharding through `lax.scan`,
* pooled observables (`psum`-style means) and replica exchange
  (`ppermute`, parallel.remc) use the interconnect when communication is
  needed.

Works identically on a multi-GPU host and on the CPU virtual-device mesh
(`--xla_force_host_platform_device_count=N`) used in tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAINS = "chains"


def make_mesh(n_devices=None, devices=None):
    """1-D mesh over the chains axis.

    Raises when the default backend has fewer devices than requested;
    it never substitutes another platform's devices.
    """
    if devices is None:
        devices = jax.devices()
        want = n_devices or len(devices)
        if len(devices) < want:
            raise ValueError(
                f"make_mesh: {want} devices requested, the "
                f"{jax.default_backend()} backend has {len(devices)}")
        devices = devices[:want]
    return Mesh(np.asarray(devices), (CHAINS,))


def chain_sharding(mesh):
    """NamedSharding that shards the leading (chains) axis."""
    return NamedSharding(mesh, P(CHAINS))


def replicated(mesh):
    return NamedSharding(mesh, P())


def shard_state(state, mesh):
    """Place a SimState with its chain-batched fields sharded over the mesh
    and scalar fields replicated (specs from state_specs)."""
    specs = state_specs(state)
    return jax.tree.map(
        lambda x, sp: jax.device_put(jnp.asarray(x), NamedSharding(mesh, sp)),
        state, specs)


def pooled_mean(x, axis=0):
    """Cross-chain mean; under jit over a sharded array XLA lowers the
    reduction to an all-reduce."""
    return jnp.mean(x, axis=axis)


def state_specs(state):
    """PartitionSpecs for a SimState: chain-batched fields shard over the
    chains axis, scalars replicate."""
    n = state.com.shape[0]

    def spec(x):
        return P(CHAINS) if (hasattr(x, "ndim") and x.ndim >= 1
                             and x.shape[0] == n) else P()

    return jax.tree.map(spec, state,
                        is_leaf=lambda x: not isinstance(x, tuple))


def sharded_run_steps(mc, state, mesh, n_steps, adjust=False,
                      remc_every=0, remc_key=None, phase0=0):
    """Run n_steps sweeps with the chain axis explicitly sharded via
    shard_map: each device advances its own chains independently (the MC
    hot loop is chain-local, so there are no collectives).

    Results match unsharded runs of the same chains bitwise on the CPU
    mesh (tests/test_parallel.py).

    remc_every > 0 interleaves replica-exchange rounds (alternating
    even/odd phases starting at phase0) every remc_every sweeps, using
    the shard-local exchange whose cross-device partner traffic is
    explicit `ppermute` edge swaps (parallel.remc.exchange_shardlocal).
    Returns (state, swap_fracs (n_rounds,)) in that mode, else state.
    """
    from metropolismontecarlo_tpu.parallel.remc import exchange_shardlocal

    specs = state_specs(state)
    n_dev = mesh.shape[CHAINS]

    if not remc_every:
        def fn(st):
            return mc.run_steps(st, n_steps, adjust)

        return jax.shard_map(fn, mesh=mesh, in_specs=(specs,),
                             out_specs=specs, check_vma=False)(state)

    if n_steps % remc_every:
        raise ValueError("n_steps must be a multiple of remc_every")
    n_rounds = n_steps // remc_every

    def fn(st):
        fracs = []
        for r in range(n_rounds):
            st = mc.run_steps(st, remc_every, adjust)
            st, frac = exchange_shardlocal(
                st, jax.random.fold_in(remc_key, r), (phase0 + r) % 2,
                n_dev, axis_name=CHAINS)
            fracs.append(frac)
        return st, jnp.stack(fracs)

    return jax.shard_map(
        fn, mesh=mesh, in_specs=(specs,),
        out_specs=(specs, P()), check_vma=False)(state)
