"""Halo exchange: the one collective the streaming-DSP pipeline needs.

Filter history between time shards moves as a cyclic permute between
devices (SURVEY.md §2.11): shard i receives shard i-1's tail.
Cyclic wrap makes block streaming seamless — shard 0's "previous samples"
are the last shard's tail, i.e. the end of the previous block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cubicsdr.ops.planar import xcat, xtail


def halo_exchange(x, n_halo: int, axis_name: str = "time"):
    """Inside shard_map: return shard i-1's last ``n_halo`` samples
    (cyclically). x: [..., L_local] array, PC, or pytree of arrays."""
    tail = jax.tree.map(lambda p: p[..., p.shape[-1] - n_halo:], x)
    n = jax.lax.psum(1, axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    return jax.lax.ppermute(tail, axis_name, perm)


def with_halo(x: jax.Array, n_halo: int, axis_name: str = "time"):
    """Concatenate the received (cyclic) halo in front of the local shard.
    NOTE: shard 0 receives the CURRENT block's global tail — fine for
    spatially-cyclic data, wrong for streaming. Use ``streaming_halo`` for
    block streams."""
    return jnp.concatenate([halo_exchange(x, n_halo, axis_name), x], axis=-1)


def streaming_halo(x, n_halo: int, carry, axis_name: str = "time"):
    """Streaming-correct halo: shard i>0 uses shard i-1's current tail; shard
    0 uses ``carry`` (the PREVIOUS block's global tail, which the cyclic
    permute delivered to it last step).

    Returns (z, new_carry) where z = [halo, x] along the last axis and
    ``new_carry`` is what this shard received this step (becoming shard 0's
    history exactly when the permute wraps). One ppermute per stage per block.
    x/carry may be arrays, PC planes, or matching pytrees.
    """
    received = halo_exchange(x, n_halo, axis_name)
    t = jax.lax.axis_index(axis_name)
    used = jax.tree.map(lambda c, r: jnp.where(t == 0, c, r),
                        carry, received)
    z = jax.tree.map(lambda u, p: jnp.concatenate([u, p], axis=-1),
                     used, x)
    return z, received
