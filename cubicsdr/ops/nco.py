"""Numerically-controlled oscillator as a vectorized phasor ramp.

The reference mixes every demodulator's channel down with a per-sample
``nco_crcf_mix_block_up/down`` loop (ref: src/demod/DemodulatorPreThread.cpp:
153-195). Here the NCO is a closed-form ramp ``exp(j*(phase0 + f*n))``
over the whole block — one fused elementwise kernel, no recurrence — with the
end phase carried across blocks for bit-continuous streaming.

Frequency is a *traced* scalar: retunes do not recompile.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cubicsdr.stream.op import StreamOp
from cubicsdr.ops.planar import PC, pc_mul, phasor_ramp_outer

TWO_PI = 2.0 * jnp.pi


def phasor_ramp(phase0: jax.Array, omega: jax.Array, n: int) -> jax.Array:
    """exp(j*(phase0 + omega*k)) for k in [0, n). Wraps the ramp argument to
    keep float32 precision over long blocks."""
    k = jnp.arange(n, dtype=jnp.float32)
    theta = jnp.mod(phase0 + omega * k, TWO_PI).astype(jnp.float32)
    return jax.lax.complex(jnp.cos(theta), jnp.sin(theta))


def mix(x: jax.Array, phase0: jax.Array, omega: jax.Array):
    """Multiply x [..., L] by the phasor ramp; returns (y, next_phase)."""
    L = x.shape[-1]
    y = x * phasor_ramp(phase0, omega, L)
    next_phase = jnp.mod(phase0 + omega * L, TWO_PI)
    return y, next_phase


class NCOMixer(StreamOp):
    """Stateful frequency shifter.

    ``apply(state, (x, omega))`` where omega = 2*pi*f_shift/sample_rate
    (positive shifts spectrum up). ``batch_shape`` batches independent NCOs
    (one per demod channel) with independent phases.
    """

    def __init__(self, batch_shape: tuple = ()):
        self.batch_shape = batch_shape

    def init_state(self):
        return jnp.zeros(self.batch_shape, jnp.float32)

    def apply(self, phase, inputs):
        x, omega = inputs
        omega = jnp.asarray(omega, jnp.float32)
        if isinstance(x, PC):
            # Planar fast path: outer-product phasor ramp (2*sqrt(L)
            # transcendentals instead of 2L — see phasor_ramp_outer).
            omega_b = (jnp.broadcast_to(omega, self.batch_shape)
                       if self.batch_shape else omega)
            rot = phasor_ramp_outer(jnp.asarray(phase, jnp.float32),
                                    omega_b, x.shape[-1])
            nxt = jnp.mod(phase + omega_b * x.shape[-1], TWO_PI)
            return nxt, pc_mul(x, rot)
        if self.batch_shape:
            omega = jnp.broadcast_to(omega, self.batch_shape)
            y, _ = mix(x, phase[..., None], omega[..., None])
            nxt = jnp.mod(phase + omega * x.shape[-1], TWO_PI)
            return nxt, y
        y, nxt = mix(x, phase, omega)
        return nxt, y
