"""FM quadrature discriminator.

Equivalent of liquid ``freqdem`` (created with kf=0.5,
ref: src/modules/modem/analog/ModemFM.cpp:7,36): output is the per-sample
phase increment scaled by 1/(2*pi*kf). Pure elementwise math — the only
state is the previous sample carried across blocks.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.stream.op import StreamOp
from cubicsdr.ops.planar import (
    PC, PLANAR, dtype_ones, pc_concat, pc_mul_conj, fast_atan2)


def freqdem_block(prev, x, kf: float = 0.5, fast_math: bool = True):
    """prev: [...] complex/PC; x: [..., L] same kind. Returns
    (new_prev, audio). PC data uses the polynomial atan2 by default
    (max err ~2.4e-7 rad, >40 dB below the 60 dB chain floor)."""
    scale = np.float32(1.0 / (2.0 * np.pi * kf))
    if isinstance(x, PC):
        z = pc_concat([PC(prev.re[..., None], prev.im[..., None]), x])
        d = pc_mul_conj(z.slice_last(slice(1, None)),
                        z.slice_last(slice(0, -1)))
        atan2 = fast_atan2 if fast_math else jnp.arctan2
        audio = atan2(d.im, d.re) * scale
        last = x.slice_last(slice(-1, None))
        return PC(last.re[..., 0], last.im[..., 0]), audio
    z = jnp.concatenate([prev[..., None], x], axis=-1)
    d = z[..., 1:] * jnp.conj(z[..., :-1])
    audio = jnp.arctan2(d.imag, d.real) * scale
    return x[..., -1], audio.astype(jnp.float32)


class FreqDem(StreamOp):
    def __init__(self, kf: float = 0.5, batch_shape: tuple = (),
                 dtype=jnp.complex64, fast_math: bool = True):
        self.kf = float(kf)
        self.batch_shape = batch_shape
        self.dtype = dtype
        self.fast_math = fast_math

    def init_state(self):
        # Start at 1+0j so the first sample's phase difference is the true
        # phase of x[0] rather than an arctan2(0,0) artifact.
        return dtype_ones(self.batch_shape, self.dtype)

    def apply(self, prev, x):
        return freqdem_block(prev, x, self.kf, self.fast_math)

    # Time-sharding: state = the previous input sample.
    shard_kind = "tail"

    def shard_halo_len(self) -> int:
        return 1

    def state_from_tail(self, tail):
        if isinstance(tail, PC):
            return PC(tail.re[..., 0], tail.im[..., 0])
        return tail[..., 0]

    def shard_carry_init(self):
        s = dtype_ones(self.batch_shape, self.dtype)
        return (PC(s.re[..., None], s.im[..., None]) if isinstance(s, PC)
                else s[..., None])
