"""Scope processor: audio waveform traces + audio spectrum.

Parity with ScopeVisualProcessor (ref: src/process/ScopeVisualProcessor.cpp:
45-216): waveform modes Y (mono), 2Y (stereo split), XY (I/Q lissajous);
audio FFT with the same double-EMA + floor/ceil mapping as the main
spectrum.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.stream.op import StreamOp
from cubicsdr.visual.spectrum import SpectrumProcessor


def scope_trace(audio: jax.Array, mode: str = "Y"):
    """audio: [C, L] float. Returns plot-ready traces:
      Y  -> [1, L] mono (channel mean)
      2Y -> [2, L] stereo pair
      XY -> [2, L] (x=left, y=right) lissajous pairs
    """
    if mode == "Y":
        return jnp.mean(audio, axis=-2, keepdims=True)
    if mode == "2Y":
        return audio if audio.shape[-2] == 2 else jnp.concatenate(
            [audio, audio], axis=-2)
    if mode == "XY":
        a = audio if audio.shape[-2] == 2 else jnp.concatenate(
            [audio, audio], axis=-2)
        return a
    raise ValueError(mode)


class ScopeProcessor(StreamOp):
    """Audio spectrum via the shared spectrum core (the reference reuses the
    same EMA math for the audio FFT, ref: ScopeVisualProcessor.cpp:121-215).
    """

    def __init__(self, fft_size: int = 1024, fft_average_rate: float = 0.65):
        self.core = SpectrumProcessor(fft_size, fft_average_rate)
        self.n = self.core.n

    def init_state(self):
        return self.core.init_state()

    def apply(self, state, audio):
        """audio: [C, L] -> spectrum of the mono mix; frames from
        non-overlapping windows of the block."""
        mono = jnp.mean(audio, axis=-2)
        n_frames = mono.shape[-1] // self.n
        if n_frames == 0:
            pad = jnp.zeros(self.n - mono.shape[-1], mono.dtype)
            frames = jnp.concatenate([mono, pad])[None, :]
        else:
            frames = mono[: n_frames * self.n].reshape(n_frames, self.n)
        return self.core.apply(state, frames.astype(jnp.complex64))
