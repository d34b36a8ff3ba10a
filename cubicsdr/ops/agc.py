"""Block-level automatic gain control.

Mirrors ModemAnalog's slow "autoGain": a double-EMA (rate 0.025/block) of the
per-block output ceiling, gain = 0.5 / smoothed ceiling
(ref: src/modules/modem/ModemAnalog.cpp:67-93). Entirely block-granular in the
reference too, so it maps to an array program with no scan at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cubicsdr.stream.op import StreamOp


class AutoGain(StreamOp):
    """``time_axis``: when the block's time axis is sharded over a mesh axis
    (parallel/sharded.py), the per-block ceiling becomes a pmax over that
    axis so the EMA state stays replicated-identical on every time shard."""

    def __init__(self, rate: float = 0.025, target: float = 0.5,
                 batch_shape: tuple = (), time_axis: str | None = None):
        self.rate = float(rate)
        self.target = float(target)
        self.batch_shape = batch_shape
        self.time_axis = time_axis

    def init_state(self):
        # Distinct arrays (shared objects break buffer donation).
        return (jnp.ones(self.batch_shape, jnp.float32),   # prev ceil
                jnp.ones(self.batch_shape, jnp.float32),   # ceil_ma
                jnp.ones(self.batch_shape, jnp.float32))   # ceil_maa

    def apply(self, state, x):
        ceil_prev, ceil_ma, ceil_maa = state
        # Reference ordering: smooth the *previous* block's (pre-gain) ceiling
        # into the MAs, measure this block's ceiling pre-gain, then apply
        # gain = target / MAA.
        ceil_ma = ceil_ma + (ceil_prev - ceil_ma) * self.rate
        ceil_maa = ceil_maa + (ceil_ma - ceil_maa) * self.rate
        ceil = jnp.max(x, axis=-1)
        if self.time_axis is not None:
            ceil = jax.lax.pmax(ceil, self.time_axis)
        gain = self.target / jnp.maximum(ceil_maa, 1e-9)
        return (ceil, ceil_ma, ceil_maa), x * gain[..., None]
