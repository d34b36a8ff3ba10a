"""Planar spectrum processor — the complex-free waterfall path.

Same display math as visual/spectrum.py (double EMA, floor/ceil, log
normalization) but complex-free: frames arrive as planar (re, im) planes and
the FFT is the four-step matmul FFT (ops/planar.py), so the whole waterfall
pipeline runs on backends without complex support — and the 64k-point
BASELINE config #3 maps to two matmuls per frame instead of an opaque
FFT call.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.ops.planar import PC, pc_abs, pc_fft_four_step
from cubicsdr.stream.op import StreamOp
from cubicsdr.visual.spectrum import (
    SpectrumProcessor, SPECTRUM_VZM, frame_update)


def _split_factors(n: int) -> tuple[int, int]:
    n1 = 1 << (int(np.log2(n)) // 2)
    while n % n1:
        n1 >>= 1
    return n1, n // n1


class PlanarSpectrumProcessor(StreamOp):
    """frames: PC of shape [n_frames, fftSizeInternal] -> display dict.

    Reuses SpectrumProcessor's state/EMA machinery; only the |FFT| per frame
    differs (four-step planar FFT + fftshift via roll).
    """

    def __init__(self, fft_size: int = 2048, fft_average_rate: float = 0.65,
                 scale_factor: float = 1.0, peak_hold: bool = False):
        self.core = SpectrumProcessor(fft_size, fft_average_rate,
                                      scale_factor, peak_hold)
        self.fft_size = self.core.fft_size
        self.n = self.core.n
        self.n1, self.n2 = _split_factors(self.n)

    def init_state(self):
        return self.core.init_state()

    def _mag(self, frame: PC) -> jax.Array:
        X = pc_fft_four_step(frame, self.n1, self.n2)
        m = pc_abs(X)
        return jnp.roll(m, self.n // 2, axis=-1)       # fftshift

    def apply(self, state, frames: PC, dc_offset_bins=None, valid=None):
        def step(st, pv):
            pair, v = pv
            mag = self._mag(PC(pair[0], pair[1]))
            st2 = frame_update(self.core, st, mag)
            st2 = jax.tree.map(lambda a, b: jnp.where(v, a, b), st2, st)
            return st2, None

        pairs = jnp.stack([frames.re, frames.im], axis=1)  # [n, 2, N]
        if valid is None:
            valid = jnp.ones(pairs.shape[0], jnp.bool_)
        state, _ = jax.lax.scan(step, state, (pairs, valid))
        return state, self.core._points(state, dc_offset_bins)
