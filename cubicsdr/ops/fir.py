"""Stateful block FIR filtering and decimation (overlap-save streaming).

Replaces liquid's firfilt/firdecim objects. The carried state is the last
K-1 input samples — exactly the implicit history liquid keeps inside its
filter objects (SURVEY.md §5 "long-context"). Streaming block-by-block is
bit-identical to one-shot ``scipy.signal.lfilter`` on the concatenated
stream (verified in tests/test_fir.py).

Data may be real float32, complex64, or planar-complex ``PC`` (the
receiver's representation); construct with ``dtype=PLANAR`` for planar
state.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.stream.op import StreamOp
from cubicsdr.utils.convolve import conv1d
from cubicsdr.ops.planar import PLANAR, dtype_zeros, xcat, xslice, xtail


def fir_block(hist, x, taps, decim: int = 1):
    """One streaming FIR step.

    hist: [..., K-1] previous inputs; x: [..., L] with L % decim == 0.
    Both may be PC. Returns (new_hist, y) where y: [..., L // decim] and
    y[n] = sum_k taps[k] * stream[n*decim - k] (causal filtering).
    """
    z = xcat([hist, x])
    y = conv1d(z, taps, stride=decim)
    k = len(taps)
    new_hist = xtail(z, k - 1) if k > 1 else xslice(z, slice(0, 0))
    return new_hist, y


class FirFilter(StreamOp):
    """Streaming FIR; complex, planar (dtype=PLANAR), or real data; real or
    complex taps. PC data with complex taps yields PC output (the analytic-
    signal path used by SSB/FM-stereo pilot filters)."""

    def __init__(self, taps, batch_shape: tuple = (), dtype=jnp.complex64):
        self.taps = np.asarray(taps)
        self.batch_shape = batch_shape
        self.dtype = dtype

    def init_state(self):
        k = self.taps.shape[0]
        return dtype_zeros((*self.batch_shape, k - 1), self.dtype)

    def apply(self, hist, x):
        return fir_block(hist, x, self.taps, decim=1)


class DelayLine(StreamOp):
    """Pure integer-sample delay: y[t] = x[t-d] (zeros before the stream).
    O(L) copy — used to phase-align parallel paths (e.g. FM-stereo mono vs
    subcarrier, matching FIR group delays)."""

    def __init__(self, delay: int, batch_shape: tuple = (),
                 dtype=jnp.float32):
        self.delay = int(delay)
        self.batch_shape = batch_shape
        self.dtype = dtype

    def init_state(self):
        return dtype_zeros((*self.batch_shape, self.delay), self.dtype)

    def apply(self, hist, x):
        if self.delay == 0:
            return hist, x
        z = xcat([hist, x])
        y = xslice(z, slice(0, x.shape[-1]))
        return xslice(z, slice(x.shape[-1], None)), y


class FirDecimator(StreamOp):
    """Streaming FIR + decimate-by-M; block length must be a multiple of M."""

    def __init__(self, taps, decim: int, batch_shape: tuple = (),
                 dtype=jnp.complex64):
        self.taps = np.asarray(taps)
        self.decim = int(decim)
        self.batch_shape = batch_shape
        self.dtype = dtype

    def init_state(self):
        k = self.taps.shape[0]
        # Pad history to a multiple of decim so output sample n corresponds to
        # stream index n*decim (phase-aligned with one-shot lfilter[::M]).
        pad = int(np.ceil((k - 1) / self.decim)) * self.decim
        self._hist_len = pad
        return dtype_zeros((*self.batch_shape, pad), self.dtype)

    def apply(self, hist, x):
        assert x.shape[-1] % self.decim == 0
        z = xcat([hist, x])
        k = self.taps.shape[0]
        pad = hist.shape[-1]
        # Drop leading samples so the first window ends exactly at the first
        # output position: y[n] = sum_k h[k] z[pad + n*decim - k].
        start = pad - (k - 1)
        y = conv1d(xslice(z, slice(start, None)), self.taps,
                   stride=self.decim)
        new_hist = xtail(z, pad)
        return new_hist, y
