"""IIR filtering without sequential loops: associative-scan linear recurrences.

The reference uses liquid iirfilt objects for its DC blocker
(ref: src/sdr/SDRPostThread.cpp:29 — ``iirfilt_crcf_create_dc_blocker(0.0005)``),
SSB half-band lowpass (ref: src/modules/modem/analog/ModemUSB.cpp:10), FM
de-emphasis (ref: src/modules/modem/analog/ModemFMStereo.cpp:146-160), and the
pilot bandpass. Per-sample IIR loops serialize an accelerator, but every
linear recurrence has a log-depth parallel form: we run them with
``jax.lax.associative_scan`` over affine maps, so an IIR over a 64k block is
~log2(64k)=16 vector passes instead of 64k sequential steps.

The scan matrices sit in a feedback path, so every product here asks for
``Precision.HIGHEST``: a reduced-precision (TF32) product would compound
its error through the recurrence.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.stream.op import StreamOp
from cubicsdr.ops.fir import fir_block
from cubicsdr.ops.planar import PC, dtype_zeros

_HIGHEST = jax.lax.Precision.HIGHEST


def affine_scan_1st_order(c, d, y_prev, tile: int = 256):
    """Solve y[n] = c*y[n-1] + d[n] (y[-1]=y_prev) in parallel.

    d: [..., L]; c scalar. Returns y: [..., L].

    Long blocks use the BLOCKED-EXACT form instead of a full-length
    associative scan (whose log2(L) vector passes round-trip the stream
    through HBM ~17 times at 128k): within each tile of T samples the
    zero-state response is ONE [T, T] lower-triangular matmul
    (A[j, i] = c^(i-j)), the T-step carry propagates with a tiny
    associative scan over n_tiles values, and the carry folds back in as a
    rank-1 update. Same math, two passes over the data, as one matmul.
    """
    L = d.shape[-1]
    # The blocked form builds its Toeplitz/carry math with a real python
    # float; complex coefficients take the generic associative scan.
    if L >= 2 * tile and not np.iscomplexobj(c):
        return _affine_blocked(float(c), d, y_prev, tile)
    a = jnp.broadcast_to(jnp.asarray(c, d.dtype), d.shape)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, bl * ar + br

    A, B = jax.lax.associative_scan(combine, (a, d), axis=-1)
    return A * y_prev[..., None] + B


def _affine_blocked(a: float, d, y_prev, T: int):
    L = d.shape[-1]
    n_tiles = -(-L // T)
    pad = n_tiles * T - L
    dp = jnp.pad(d, [(0, 0)] * (d.ndim - 1) + [(0, pad)]) if pad else d
    dt = dp.reshape(*d.shape[:-1], n_tiles, T)
    # Zero-state tile response: one lower-triangular Toeplitz matmul.
    i = np.arange(T)
    A_np = np.where(i[None, :] >= i[:, None],
                    np.power(a, (i[None, :] - i[:, None]).astype(np.float64),
                             where=i[None, :] >= i[:, None]),
                    0.0).astype(np.float32)
    A = jnp.asarray(A_np)                             # [T(j), T(i)]
    acc = (jnp.float32 if not jnp.iscomplexobj(dp) else dp.dtype)
    y0 = jnp.einsum("...tj,ji->...ti", dt, A.astype(dp.dtype)
                    if jnp.iscomplexobj(dp) else A,
                    preferred_element_type=acc, precision=_HIGHEST)
    E = y0[..., -1]                                   # [..., n_tiles]
    # Carry recurrence s_{t+1} = a^T s_t + E_t over n_tiles (tiny scan).
    aT = jnp.asarray(a, jnp.float32) ** T
    ab = jnp.broadcast_to(aT, E.shape).astype(E.dtype)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, bl * ar + br

    Pa, Pb = jax.lax.associative_scan(combine, (ab, E), axis=-1)
    s_end = Pa * y_prev[..., None] + Pb               # carry AFTER tile t
    s_in = jnp.concatenate([y_prev[..., None], s_end[..., :-1]], axis=-1)
    pw = jnp.asarray(a, jnp.float32) ** jnp.arange(1, T + 1,
                                                   dtype=jnp.float32)
    y = y0 + s_in[..., None] * pw
    y = y.reshape(*d.shape[:-1], n_tiles * T)
    return y[..., :L] if pad else y


def affine_scan_2nd_order(m: np.ndarray, f, s_prev):
    """Solve s[n] = M s[n-1] + [f[n], 0] with constant 2x2 M, in parallel.

    f: [..., L]; s_prev: [..., 2] = [y[-1], y[-2]]. Returns (y: [..., L],
    s_last: [..., 2]). Used for biquad (SOS) sections.
    """
    L = f.shape[-1]
    M = jnp.asarray(m, f.dtype)                      # [2,2]
    Ms = jnp.broadcast_to(M, (*f.shape, 2, 2))       # [..., L, 2, 2]
    v = jnp.stack([f, jnp.zeros_like(f)], axis=-1)   # [..., L, 2]

    def combine(l, r):
        Ml, vl = l
        Mr, vr = r
        return (
            jnp.einsum("...ij,...jk->...ik", Mr, Ml, precision=_HIGHEST),
            jnp.einsum("...ij,...j->...i", Mr, vl, precision=_HIGHEST) + vr,
        )

    A, B = jax.lax.associative_scan(combine, (Ms, v), axis=-3)
    s = jnp.einsum("...ij,...j->...i", A, s_prev[..., None, :],
                   precision=_HIGHEST) + B
    return s[..., 0], s[..., -1, :]


class DCBlocker(StreamOp):
    """H(z) = (1 - z^-1) / (1 - (1-alpha) z^-1) — removes the DC spike the
    hardware leaves at the tuner center (ref: src/sdr/SDRPostThread.cpp:29,284).
    """

    def __init__(self, alpha: float = 0.0005, batch_shape: tuple = (),
                 dtype=jnp.complex64):
        self.alpha = float(alpha)
        self.batch_shape = batch_shape
        self.dtype = dtype

    def init_state(self):
        return (dtype_zeros(self.batch_shape, self.dtype),   # x[-1]
                dtype_zeros(self.batch_shape, self.dtype))   # y[-1]

    def _plane(self, x_prev, y_prev, x):
        xd = jnp.concatenate([x_prev[..., None], x], axis=-1)
        d = xd[..., 1:] - xd[..., :-1]
        return affine_scan_1st_order(1.0 - self.alpha, d, y_prev)

    def apply(self, state, x):
        x_prev, y_prev = state
        if isinstance(x, PC):
            yr = self._plane(x_prev.re, y_prev.re, x.re)
            yi = self._plane(x_prev.im, y_prev.im, x.im)
            new = (PC(x.re[..., -1], x.im[..., -1]),
                   PC(yr[..., -1], yi[..., -1]))
            return new, PC(yr, yi)
        y = self._plane(x_prev, y_prev, x)
        return (x[..., -1], y[..., -1]), y

    # --- time-sharding: EXACT cross-shard composition of the recurrence.
    # The local scan with zero initial state is affine in the true initial
    # state: y[n] = y0[n] + a^{n+1} * s0. Each shard publishes its zero-state
    # end value E via one small all_gather; shard t then reconstructs its
    # true s0 = a^L*... prefix locally. ---
    def shard_carries(self):
        from cubicsdr.ops.planar import dtype_zeros
        return (dtype_zeros((*self.batch_shape, 1), self.dtype),   # x tail
                dtype_zeros(self.batch_shape, self.dtype))         # y @ end

    def shard_apply(self, carries, x, axis):
        import jax as _jax
        from cubicsdr.parallel.halo import streaming_halo
        c_x, y_end = carries
        z, new_cx = streaming_halo(x, 1, c_x, axis)
        a = 1.0 - self.alpha
        t = _jax.lax.axis_index(axis)
        n_t = _jax.lax.psum(1, axis)

        def plane(zp, y_end_p):
            L = zp.shape[-1] - 1
            d = zp[..., 1:] - zp[..., :-1]
            y0 = affine_scan_1st_order(a, d, jnp.zeros_like(y_end_p))
            E = y0[..., -1]                       # zero-state end value
            F = jnp.float32(a) ** L               # decay across one shard
            Es = _jax.lax.all_gather(E, axis)     # [n_t, ...]
            j = jnp.arange(Es.shape[0], dtype=jnp.float32)
            tf = jnp.asarray(t, jnp.float32)
            w = jnp.where(j < tf, F ** (tf - 1.0 - j), 0.0)
            s0 = (F ** tf) * y_end_p + jnp.tensordot(w, Es, axes=(0, 0),
                                                      precision=_HIGHEST)
            pw = jnp.float32(a) ** jnp.arange(1, L + 1, dtype=jnp.float32)
            y = y0 + pw * s0[..., None]
            ntf = jnp.float32(n_t)
            w_all = F ** (ntf - 1.0 - j)
            y_end_new = (F ** ntf) * y_end_p + jnp.tensordot(
                w_all, Es, axes=(0, 0), precision=_HIGHEST)
            return y, y_end_new

        if isinstance(x, PC):
            yr, er = plane(z.re, y_end.re)
            yi, ei = plane(z.im, y_end.im)
            return (new_cx, PC(er, ei)), PC(yr, yi)
        y, e = plane(z, y_end)
        return (new_cx, e), y


class SOSFilter(StreamOp):
    """Cascaded biquads (scipy sos layout [n_sections, 6]) with streaming state.

    Matches ``scipy.signal.sosfilt`` on the concatenated stream. Sections run
    sequentially (few of them); each section is a parallel associative scan.
    """

    def __init__(self, sos: np.ndarray, batch_shape: tuple = (),
                 dtype=jnp.float32):
        sos = np.asarray(sos, np.float64)
        assert sos.ndim == 2 and sos.shape[1] == 6
        self.sos = sos
        self.batch_shape = batch_shape
        self.dtype = dtype

    def init_state(self):
        n = self.sos.shape[0]
        return tuple(
            (jnp.zeros((*self.batch_shape, 2), self.dtype),   # x hist [x-1, x-2]
             jnp.zeros((*self.batch_shape, 2), self.dtype))   # y hist [y-1, y-2]
            for _ in range(n)
        )

    def apply(self, state, x):
        new_state = []
        for i, (xh, yh) in enumerate(state):
            b0, b1, b2, _, a1, a2 = self.sos[i]
            taps = jnp.asarray([b0, b1, b2], x.dtype)
            xh, f = fir_block(xh, x, taps)
            M = np.array([[-a1, -a2], [1.0, 0.0]])
            x, yh = affine_scan_2nd_order(M, f, yh)
            new_state.append((xh, yh))
        return tuple(new_state), x


class FirstOrderIIR(StreamOp):
    """y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1] (e.g. FM de-emphasis,
    ref: src/modules/modem/analog/ModemFMStereo.cpp:271-288)."""

    def __init__(self, b, a, batch_shape: tuple = (), dtype=jnp.float32):
        b = np.asarray(b, np.float64)
        a = np.asarray(a, np.float64)
        assert b.shape == (2,) and a.shape == (2,) and a[0] == 1.0
        self.b, self.a = b, a
        self.batch_shape = batch_shape
        self.dtype = dtype

    def init_state(self):
        return (jnp.zeros((*self.batch_shape, 1), self.dtype),
                jnp.zeros(self.batch_shape, self.dtype))

    def apply(self, state, x):
        xh, y_prev = state
        taps = jnp.asarray(self.b, x.dtype)
        xh, f = fir_block(xh, x, taps)
        y = affine_scan_1st_order(-self.a[1], f, y_prev)
        return (xh, y[..., -1]), y
