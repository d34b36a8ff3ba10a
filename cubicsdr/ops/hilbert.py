"""Analytic-signal FIR ops (firhilbf equivalents).

The reference uses liquid ``firhilbf`` for real<->complex conversions in the
SSB/CW/FM-stereo chains (ref: src/modules/modem/analog/ModemUSB.cpp:13,
ModemFMStereo.cpp). Here: FIR Hilbert transformers and complex one-sided
bandpass filters (ops.design.ssb_bandpass) doing the same job in one pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cubicsdr.ops import design
from cubicsdr.ops.fir import FirFilter
from cubicsdr.stream.op import StreamOp


class AnalyticFilter(StreamOp):
    """real -> analytic (complex) signal: x + j*H{x}, streaming.

    Implemented as one complex FIR: h_a[n] = delta_delayed[n] + j*h_hilb[n].
    """

    def __init__(self, num_taps: int = 63, batch_shape: tuple = ()):
        hh = design.hilbert_fir(num_taps)
        mid = (num_taps - 1) // 2
        delay = jnp.zeros(num_taps).at[mid].set(1.0)
        taps = delay + 1j * jnp.asarray(hh)
        self.fir = FirFilter(taps, batch_shape, dtype=jnp.float32)

    def init_state(self):
        return self.fir.init_state()

    def apply(self, state, x):
        return self.fir.apply(state, x)
