"""Windowed batched FFT helpers for spectrum/waterfall processing.

Batched complex FFTs lower to XLA's native FFT; all spectrum math
(magnitude, fftshift, EMA smoothing) stays fused elementwise around it.
(ref: liquid fft_execute use at src/process/SpectrumVisualProcessor.cpp:439.)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def fftshift_mag(X: jax.Array) -> jax.Array:
    """|FFT| with DC centered — the half-swap at
    ref: src/process/SpectrumVisualProcessor.cpp:441-452."""
    return jnp.fft.fftshift(jnp.abs(X), axes=-1)


def spectrum_frames(x: jax.Array, fft_size: int, window=None) -> jax.Array:
    """x: [..., n_frames, fft_size] -> magnitude spectra [..., n_frames,
    fft_size], DC-centered, optional window (numpy array or None)."""
    if window is not None:
        x = x * jnp.asarray(window, x.real.dtype)
    return fftshift_mag(jnp.fft.fft(x, axis=-1))


def hann(n: int) -> np.ndarray:
    return np.hanning(n).astype(np.float32)
