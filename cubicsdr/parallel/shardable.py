"""Generic time-sharding drivers for StreamOps.

The reference streams every stage sequentially with hidden liquid-dsp state
(SURVEY.md §5 "long-context"). When the block's time axis is sharded over a
mesh, that carried state becomes a *halo*: shard i needs the tail of shard
i-1's input — one cyclic ppermute per stage per block (parallel/halo.py).
``shard_stage`` drives any StreamOp declaring the protocol in stream/op.py;
block-granular EMA ops instead keep replicated state with collective
statistics (their ``time_axis`` constructor arg).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cubicsdr.ops.planar import PC, xslice
from cubicsdr.parallel.halo import streaming_halo
from cubicsdr.stream.op import StreamOp

TWO_PI = 6.283185307179586


def shard_stage(op: StreamOp, carry, x, axis: str):
    """Run one StreamOp on a time shard. Returns (new_carry, y).

    tail ops:       carry = input-tail halo (exchanged here)
    replicated ops: carry = the op's own state (collectives inside apply)
    stateless ops:  carry = ()
    """
    kind = op.shard_kind
    if kind == "stateless":
        _, y = op.apply(op.init_state(), x)
        return (), y
    if kind == "replicated":
        return op.apply(carry, x)
    if kind == "tail":
        h = op.shard_halo_len()
        z, new_carry = streaming_halo(x, h, carry, axis)
        state = op.state_from_tail(xslice(z, slice(0, h)))
        _, y = op.apply(state, xslice(z, slice(h, None)))
        return new_carry, y
    raise NotImplementedError(
        f"{type(op).__name__} declares no time-sharding kind")


def shard_stage_carry_init(op: StreamOp):
    if op.shard_kind == "stateless":
        return ()
    if op.shard_kind == "replicated":
        return op.init_state()
    return op.shard_carry_init()


def nco_shard_mix(base_phase, omega, x: PC, axis: str):
    """Planar NCO mix with closed-form phase continuity across time shards:
    shard t starts at phase base + omega * (t * L_local); the base advances
    by a whole global block per step. No collective needed.

    base_phase/omega: [...] per-demod; x: PC [..., L_local].
    Returns (new_base, y).
    """
    from cubicsdr.ops.planar import phasor_ramp_outer, pc_mul
    L = x.shape[-1]
    t = jnp.asarray(jax.lax.axis_index(axis), jnp.float32)
    n_t = jnp.float32(jax.lax.psum(1, axis))
    phase0 = jnp.mod(base_phase + omega * (t * L), TWO_PI)
    rot = phasor_ramp_outer(phase0, omega, L)
    new_base = jnp.mod(base_phase + omega * (n_t * L), TWO_PI)
    return new_base, pc_mul(x, rot)
