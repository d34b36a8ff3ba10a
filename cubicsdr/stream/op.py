"""StreamOp protocol: the universal stage contract.

Every DSP stage is a pure function ``(state, x) -> (state, y)`` where ``state``
is an arbitrary pytree of carried arrays (filter history, NCO phase, EMA
accumulators — the explicit analog of liquid-dsp's hidden per-object state that
the reference carries across calls, see SURVEY.md §5 "long-context").

Stages compose with ``Chain`` and stream with ``scan_blocks`` (a ``lax.scan``
over pre-staged blocks — the jit-compiled replacement for the reference's
thread-per-stage pipeline, ref: src/CubicSDR.cpp:342-397).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp

State = Any


class StreamOp:
    """Base class: subclasses define ``init_state()`` and ``apply(state, x)``.

    Ops must be shape-preserving-or-statically-resizing: output length is a
    function of input length and construction params only (XLA static shapes).

    Time-sharding protocol (parallel/sharded.py): when the block's time axis
    is split across mesh devices, an op participates in one of three ways,
    declared by ``shard_kind``:
      "tail"       — carried state is reconstructable from the last
                     ``shard_halo_len()`` input samples (FIR history,
                     resampler history, freqdem prev-sample). The sharding
                     driver halo-exchanges the input tail between time shards
                     (one cyclic ppermute) and calls ``state_from_tail``.
      "replicated" — state is block-granular (EMA accumulators) and stays
                     identical on every time shard because the op computes
                     its block statistics with collectives (construct the op
                     with ``time_axis=<mesh axis>``).
      "stateless"  — no carried state at all.
    Composite kits implement ``shard_apply(carries, x, axis)`` directly,
    composing their parts via parallel.shardable.shard_stage.
    """

    shard_kind: str | None = None     # "tail" | "replicated" | "stateless"

    def init_state(self) -> State:
        return ()

    def apply(self, state: State, x):
        raise NotImplementedError

    # --- time-sharding protocol (defaults for tail-kind ops) ---
    def shard_halo_len(self) -> int:
        raise NotImplementedError(f"{type(self).__name__} is not shardable")

    def state_from_tail(self, tail):
        """Rebuild the carried state from the last shard_halo_len() input
        samples (tail arrives in the op's input representation)."""
        return tail

    def shard_carry_init(self):
        """Initial halo carry (the input tail at stream start)."""
        raise NotImplementedError

    def shard_carries(self):
        """Initial carries for shard_apply (composites override)."""
        from cubicsdr.parallel.shardable import shard_stage_carry_init
        return shard_stage_carry_init(self)

    def shard_apply(self, carries, x, axis: str):
        """Run this op on a time shard inside shard_map (composites
        override, composing their parts via parallel.shardable)."""
        from cubicsdr.parallel.shardable import shard_stage
        return shard_stage(self, carries, x, axis)

    def __call__(self, state: State, x):
        return self.apply(state, x)


class Chain(StreamOp):
    """Sequential composition of StreamOps; state is a tuple of stage states."""

    def __init__(self, *ops: StreamOp):
        self.ops = ops

    def init_state(self):
        return tuple(op.init_state() for op in self.ops)

    def apply(self, state, x):
        new_states = []
        for op, s in zip(self.ops, state):
            s, x = op.apply(s, x)
            new_states.append(s)
        return tuple(new_states), x


def scan_blocks(op: StreamOp | Callable, state: State, blocks):
    """Run ``op`` over a leading blocks axis with carried state via lax.scan.

    ``blocks``: pytree whose leaves have shape [n_blocks, ...block shape...].
    Returns (final_state, stacked_outputs). This is how a long capture is
    processed as a stream while remaining one compiled program.
    """
    fn = op.apply if isinstance(op, StreamOp) else op

    def body(s, blk):
        s, y = fn(s, blk)
        return s, y

    return jax.lax.scan(body, state, blocks)


def split_blocks(x: jax.Array, block_len: int) -> jax.Array:
    """Frame a 1-D (or [..., N]) array into [..., n_blocks, block_len], dropping
    the ragged tail (the host feeder's job in live mode; ref overflow-carry
    behavior: src/sdr/SoapySDRThread.cpp:223-243)."""
    n = x.shape[-1] // block_len
    return x[..., : n * block_len].reshape(*x.shape[:-1], n, block_len)
