"""Batched 1-D convolution helpers built on XLA's conv primitive.

These are the workhorses under every FIR op, built on
``lax.conv_general_dilated``; complex data is decomposed into real planes.
Every conv asks for ``Precision.HIGHEST``: at default precision a GPU may
run float32 convs in TF32 (~10 mantissa bits), well short of the filters'
60 dB stopbands.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _conv_real(x: jax.Array, h: jax.Array, stride: int) -> jax.Array:
    """VALID conv of real x [..., L] with real taps h [K] (correlation with
    reversed taps — true convolution), strided. Returns [..., (L-K)//stride+1].
    """
    batch_shape = x.shape[:-1]
    n = int(np.prod(batch_shape)) if batch_shape else 1
    xr = x.reshape(n, 1, x.shape[-1])
    hk = h[::-1].reshape(1, 1, h.shape[0]).astype(x.dtype)
    y = lax.conv_general_dilated(
        xr, hk, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    return y.reshape(*batch_shape, y.shape[-1])


def conv1d(x, h, stride: int = 1):
    """True convolution (VALID) along the last axis; supports complex or
    planar-complex (PC) x and/or complex h via real-plane decomposition.
    x: [..., L] (array or PC), h: [K]."""
    from cubicsdr.ops.planar import PC
    if isinstance(x, PC):
        hn = np.asarray(h)
        if np.iscomplexobj(hn):
            hr = jnp.asarray(hn.real.astype(np.float32))
            hi = jnp.asarray(hn.imag.astype(np.float32))
            rr = _conv_real(x.re, hr, stride)
            ii = _conv_real(x.im, hi, stride)
            ri = _conv_real(x.re, hi, stride)
            ir = _conv_real(x.im, hr, stride)
            return PC(rr - ii, ri + ir)
        hr = jnp.asarray(hn.astype(np.float32))
        return PC(_conv_real(x.re, hr, stride), _conv_real(x.im, hr, stride))
    h = jnp.asarray(h)
    cx = jnp.iscomplexobj(x)
    ch = jnp.iscomplexobj(h)
    if not cx and not ch:
        return _conv_real(x, h, stride)
    if cx and not ch:
        return (_conv_real(x.real, h, stride)
                + 1j * _conv_real(x.imag, h, stride)).astype(jnp.complex64)
    if not cx and ch:
        return (_conv_real(x, h.real, stride)
                + 1j * _conv_real(x, h.imag, stride)).astype(jnp.complex64)
    rr = _conv_real(x.real, h.real, stride)
    ii = _conv_real(x.imag, h.imag, stride)
    ri = _conv_real(x.real, h.imag, stride)
    ir = _conv_real(x.imag, h.real, stride)
    return ((rr - ii) + 1j * (ri + ir)).astype(jnp.complex64)


def conv1d_multi(x: jax.Array, hs: jax.Array, stride: int = 1) -> jax.Array:
    """Convolve one signal with P real filter banks at once.

    x: real [..., L]; hs: [P, K]. Returns [..., P, (L-K)//stride+1]. One XLA
    conv with P output features — one wide conv for a polyphase bank.
    """
    batch_shape = x.shape[:-1]
    n = int(np.prod(batch_shape)) if batch_shape else 1
    xr = x.reshape(n, 1, x.shape[-1])
    hk = hs[:, ::-1][:, None, :].astype(x.dtype)  # [P, 1, K]
    y = lax.conv_general_dilated(
        xr, hk, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    return y.reshape(*batch_shape, hs.shape[0], y.shape[-1])


def conv1d_grouped(x: jax.Array, hs: jax.Array, stride: int = 1,
                   dilation: int = 1) -> jax.Array:
    """Depthwise conv: channel c of x filtered by hs[c], optional tap dilation.

    x: [..., C, L] (real or complex); hs: real [C, K]. Returns
    [..., C, (L - (K-1)*dilation - 1)//stride + 1]. Uses
    feature_group_count=C (one group per polyphase branch).
    """
    from cubicsdr.ops.planar import PC
    if isinstance(x, PC):
        return PC(conv1d_grouped(x.re, hs, stride, dilation),
                  conv1d_grouped(x.im, hs, stride, dilation))
    if jnp.iscomplexobj(x):
        return (conv1d_grouped(x.real, hs, stride, dilation)
                + 1j * conv1d_grouped(x.imag, hs, stride, dilation)
                ).astype(jnp.complex64)
    batch_shape = x.shape[:-2]
    C, L = x.shape[-2], x.shape[-1]
    n = int(np.prod(batch_shape)) if batch_shape else 1
    xr = x.reshape(n, C, L)
    hk = hs[:, ::-1][:, None, :].astype(x.dtype)  # [C, 1, K]
    y = lax.conv_general_dilated(
        xr, hk, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        feature_group_count=C,
        rhs_dilation=(dilation,),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    return y.reshape(*batch_shape, C, y.shape[-1])


def frame_signal(x: jax.Array, frame_len: int, hop: int) -> jax.Array:
    """[..., L] -> [..., n_frames, frame_len] with stride ``hop`` (gather-free:
    uses conv-style slicing via reshape when hop divides, else dynamic gather).
    """
    L = x.shape[-1]
    n_frames = (L - frame_len) // hop + 1
    idx = (np.arange(n_frames)[:, None] * hop + np.arange(frame_len)[None, :])
    return x[..., idx]
