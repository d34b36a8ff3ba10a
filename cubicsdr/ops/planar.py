"""Planar complex arithmetic — the receiver's complex representation.

The hot path carries IQ as two float32 planes (re, im): elementwise complex
ops fuse as plain real math, and the channelizer's DFT becomes a real
matmul pair against a planar DFT matrix instead of an opaque complex FFT.
Whether planar beats complex64 on a given device is measured, not assumed
(ROADMAP Design 3).

A ``PC`` pair is just a tuple-like pytree (re, im); helpers below implement
the complex algebra and the conv/DFT primitives used by the planar receiver
(receiver/pipeline.py, dtype=PLANAR).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


class PC(NamedTuple):
    """Planar complex: two same-shape real arrays."""
    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    def __getitem__(self, idx):
        if isinstance(idx, int):           # preserve NamedTuple field access
            return tuple.__getitem__(self, idx)
        return PC(self.re[idx], self.im[idx])

    def slice_last(self, sl):
        return PC(self.re[..., sl], self.im[..., sl])


def from_complex(x) -> PC:
    x = np.asarray(x)
    return PC(jnp.asarray(x.real.astype(np.float32)),
              jnp.asarray(x.imag.astype(np.float32)))


def as_pc(x) -> PC:
    """Coerce a complex (or PC) value to planar form. Works under jit on
    complex tracers (CPU tests); the planar pipeline passes PC directly."""
    if isinstance(x, PC):
        return x
    return PC(jnp.real(x).astype(jnp.float32),
              jnp.imag(x).astype(jnp.float32))


def to_complex(x: PC) -> np.ndarray:
    return np.asarray(x.re) + 1j * np.asarray(x.im)


def pc_zeros(shape, dtype=jnp.float32) -> PC:
    return PC(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


# Sentinel dtype value: ops constructed with dtype=PLANAR carry planar-complex
# state/data (two float32 planes) instead of complex64. Streaming ops accept
# it anywhere they accept jnp.complex64/jnp.float32.
PLANAR = "pc"


def dtype_zeros(shape, dtype):
    """zeros() that understands the PLANAR sentinel."""
    if dtype == PLANAR:
        return pc_zeros(shape)
    return jnp.zeros(shape, dtype)


def dtype_ones(shape, dtype):
    """ones() (1+0j for complex kinds) understanding the PLANAR sentinel."""
    if dtype == PLANAR:
        return PC(jnp.ones(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    return jnp.ones(shape, dtype)


def xcat(parts, axis=-1):
    """Concatenate arrays or PCs (all parts must be the same kind)."""
    if isinstance(parts[0], PC):
        return pc_concat(parts, axis=axis)
    return jnp.concatenate(parts, axis=axis)


def xslice(z, sl):
    """Slice the last axis of an array or PC."""
    if isinstance(z, PC):
        return z.slice_last(sl)
    return z[..., sl]


def xtail(z, n: int):
    """Last ``n`` samples along the last axis (array or PC)."""
    L = z.shape[-1] if isinstance(z, PC) else z.shape[-1]
    return xslice(z, slice(L - n, None))


def planes_of(x):
    """(re, im) float32 planes of a PC or complex array — the planes-first
    idiom: demod kits compute in real planes so ONE code path serves both
    the complex64 (CPU test) and planar representations."""
    if isinstance(x, PC):
        return x.re, x.im
    return (jnp.real(x).astype(jnp.float32),
            jnp.imag(x).astype(jnp.float32))


def join_like(re, im, like):
    """Assemble (re, im) into the same representation as ``like``."""
    if isinstance(like, PC):
        return PC(re, im)
    return (re + 1j * im).astype(jnp.complex64)


def pc_mul(a: PC, b: PC) -> PC:
    return PC(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def pc_mul_conj(a: PC, b: PC) -> PC:
    """a * conj(b)."""
    return PC(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def pc_abs2(a: PC) -> jax.Array:
    return a.re * a.re + a.im * a.im


def pc_abs(a: PC) -> jax.Array:
    return jnp.sqrt(pc_abs2(a))


def pc_concat(parts, axis=-1) -> PC:
    return PC(jnp.concatenate([p.re for p in parts], axis=axis),
              jnp.concatenate([p.im for p in parts], axis=axis))


def pc_take(a: PC, idx, axis) -> PC:
    return PC(jnp.take(a.re, idx, axis=axis), jnp.take(a.im, idx, axis=axis))


def phasor(theta) -> PC:
    return PC(jnp.cos(theta), jnp.sin(theta))


def pc_arctan2(a: PC) -> jax.Array:
    return jnp.arctan2(a.im, a.re)


def phasor_ramp_outer(theta0: jax.Array, omega: jax.Array, L: int,
                      block: int = 512) -> PC:
    """exp(j*(theta0 + omega*k)) for k in [0, L) via the angle-addition outer
    product: k = a*B + b  =>  phasor = P1[a] * P2[b], needing only
    A+B ~ 2*sqrt(L) cos/sin evaluations instead of 2L (the NCO mix is
    transcendental-bound; this turns it into complex multiplies).

    theta0/omega: [...] broadcastable leading dims. Returns PC [..., L].
    Arguments to cos/sin are wrapped mod 2*pi to keep float32 accuracy.
    """
    B = block
    A = -(-L // B)
    a = jnp.arange(A, dtype=jnp.float32) * B
    b = jnp.arange(B, dtype=jnp.float32)
    th_a = jnp.mod(theta0[..., None] + omega[..., None] * a, TWO_PI_F)
    th_b = jnp.mod(omega[..., None] * b, TWO_PI_F)
    p1 = PC(jnp.cos(th_a), jnp.sin(th_a))          # [..., A]
    p2 = PC(jnp.cos(th_b), jnp.sin(th_b))          # [..., B]
    re = (p1.re[..., :, None] * p2.re[..., None, :]
          - p1.im[..., :, None] * p2.im[..., None, :])
    im = (p1.re[..., :, None] * p2.im[..., None, :]
          + p1.im[..., :, None] * p2.re[..., None, :])
    re = re.reshape(*re.shape[:-2], A * B)[..., :L]
    im = im.reshape(*im.shape[:-2], A * B)[..., :L]
    return PC(re, im)


TWO_PI_F = np.float32(2.0 * np.pi)

# Minimax-ish odd polynomial for atan on [0, 1] (fit in s = r^2; float64 fit,
# float32 eval; max abs error ~1e-7 rad — far below the 60 dB chain floor).
_ATAN_DEG = 9


@lru_cache(maxsize=None)
def _atan_coeffs():
    r = np.linspace(0, 1, 20001)[1:]
    s = r * r
    target = np.arctan(r) / r
    cheb = np.polynomial.chebyshev.Chebyshev.fit(s, target, _ATAN_DEG)
    poly = cheb.convert(kind=np.polynomial.Polynomial)
    return tuple(float(c) for c in poly.coef)


def fast_atan2(y: jax.Array, x: jax.Array) -> jax.Array:
    """Polynomial atan2 (~20 vector ops vs the library's long expansion).
    Max error ~1e-7 rad; matches jnp.arctan2 sign/quadrant conventions for
    nonzero inputs (0,0 -> 0)."""
    c = _atan_coeffs()
    ax, ay = jnp.abs(x), jnp.abs(y)
    mx = jnp.maximum(ax, ay)
    mn = jnp.minimum(ax, ay)
    r = mn / jnp.maximum(mx, 1e-37)
    s = r * r
    p = jnp.float32(c[-1])
    for k in range(len(c) - 2, -1, -1):
        p = p * s + jnp.float32(c[k])
    a = p * r
    a = jnp.where(ay > ax, jnp.float32(np.pi / 2) - a, a)
    a = jnp.where(x < 0, jnp.float32(np.pi) - a, a)
    return jnp.where(y < 0, -a, a)


# ---------------------------------------------------------------- conv ----

def conv_real(x: jax.Array, h: jax.Array, stride: int = 1,
              dilation: int = 1, groups: int = 1) -> jax.Array:
    """True conv (VALID) of real x [..., C, L] with taps h [C_out, K];
    groups = feature_group_count. For C==1 inputs pass x [..., 1, L]."""
    batch_shape = x.shape[:-2]
    C, L = x.shape[-2], x.shape[-1]
    n = int(np.prod(batch_shape)) if batch_shape else 1
    hk = h[:, ::-1][:, None, :].astype(x.dtype)
    y = lax.conv_general_dilated(
        x.reshape(n, C, L), hk, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        feature_group_count=groups, rhs_dilation=(dilation,),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,   # not TF32/bf16: true f32
    )
    return y.reshape(*batch_shape, y.shape[-2], y.shape[-1])


def pc_conv(x: PC, h: jax.Array, stride: int = 1, dilation: int = 1,
            groups: int = 1) -> PC:
    """Planar input, REAL taps: two independent real convs."""
    return PC(conv_real(x.re, h, stride, dilation, groups),
              conv_real(x.im, h, stride, dilation, groups))


# ----------------------------------------------------------- DFT matmul ----

@lru_cache(maxsize=None)
def _idft_mats_np(M: int):
    k = np.arange(M)
    W = np.exp(2j * np.pi * np.outer(k, k) / M)      # M * IDFT (no 1/M)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


def _idft_mats(M: int):
    # Cache only numpy: jnp conversion must happen per-trace (a cached array
    # created inside a shard_map/jit trace would leak a tracer).
    a, b = _idft_mats_np(M)
    return jnp.asarray(a), jnp.asarray(b)


def pc_idft_m(u: PC, axis_m: int = -2) -> PC:
    """M * inverse DFT along ``axis_m`` as two real matmuls.
    u: [..., M, T] by default."""
    Wr, Wi = _idft_mats(u.re.shape[axis_m])
    mv = lambda W, a: jnp.einsum("km,...mt->...kt", W,
                                 jnp.moveaxis(a, axis_m, -2),
                                 precision=jax.lax.Precision.HIGHEST)
    yr = mv(Wr, u.re) - mv(Wi, u.im)
    yi = mv(Wr, u.im) + mv(Wi, u.re)
    return PC(jnp.moveaxis(yr, -2, axis_m), jnp.moveaxis(yi, -2, axis_m))


@lru_cache(maxsize=None)
def _dft_mats_np(M: int):
    k = np.arange(M)
    W = np.exp(-2j * np.pi * np.outer(k, k) / M)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


def _dft_mats(M: int):
    a, b = _dft_mats_np(M)
    return jnp.asarray(a), jnp.asarray(b)


def pc_dft_m(u: PC, axis_m: int = -2) -> PC:
    """Forward DFT along ``axis_m`` as two real matmuls."""
    Wr, Wi = _dft_mats(u.re.shape[axis_m])
    mv = lambda W, a: jnp.einsum("km,...mt->...kt", W,
                                 jnp.moveaxis(a, axis_m, -2),
                                 precision=jax.lax.Precision.HIGHEST)
    yr = mv(Wr, u.re) - mv(Wi, u.im)
    yi = mv(Wr, u.im) + mv(Wi, u.re)
    return PC(jnp.moveaxis(yr, -2, axis_m), jnp.moveaxis(yi, -2, axis_m))


def pc_fft_four_step(x: PC, n1: int, n2: int) -> PC:
    """Four-step (Bailey) FFT of length N = n1*n2 along the last axis, built
    entirely from matmuls and an elementwise twiddle — the complex-free
    large FFT for the 64k spectrum config (BASELINE config #3).

    X[k1 + n1*k2] = sum_{m2} W_N^{...}: decompose x[m1*n2 + m2]? Using the
    standard decimation: view x as [n1, n2] row-major (index = i1*n2 + i2),
    DFT columns (length n1), twiddle by W_N^{i2*k1}, DFT rows (length n2),
    then read out transposed: X[k2*n1 + k1].
    """
    N = x.re.shape[-1]
    assert n1 * n2 == N
    v = PC(x.re.reshape(*x.re.shape[:-1], n1, n2),
           x.im.reshape(*x.im.shape[:-1], n1, n2))
    # DFT over the n1 axis (columns).
    v = pc_dft_m(v, axis_m=-2)
    # Twiddle W_N^{k1*i2}.
    k1 = np.arange(n1)[:, None]
    i2 = np.arange(n2)[None, :]
    tw = np.exp(-2j * np.pi * (k1 * i2) / N)
    twp = PC(jnp.asarray(tw.real.astype(np.float32)),
             jnp.asarray(tw.imag.astype(np.float32)))
    v = pc_mul(v, twp)
    # DFT over the n2 axis (rows).
    v = pc_dft_m(v, axis_m=-1)
    # Output index X[k2*n1 + k1]: transpose [n1, n2] -> [n2, n1] then flatten.
    yr = jnp.swapaxes(v.re, -1, -2).reshape(*x.re.shape[:-1], N)
    yi = jnp.swapaxes(v.im, -1, -2).reshape(*x.im.shape[:-1], N)
    return PC(yr, yi)
