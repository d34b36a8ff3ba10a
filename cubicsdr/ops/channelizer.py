"""Polyphase filter-bank channelizers — hot path #1.

Array-program equivalents of liquid's ``firpfbch_crcf`` (critically sampled
analyzer) and ``firpfbch2_crcf`` (2x oversampled), which the reference runs
per-M-samples in a scalar loop (ref: src/sdr/SDRPostThread.cpp:406,449-451,
463,504-509). Here one block is processed as:

    frames (reshape/stride)  ->  depthwise polyphase FIR (one XLA conv)
                             ->  batched M-point IFFT / planar DFT matmul
                             ->  per-channel constant phase / parity flips

Derivation: channel k's output is the input mixed down by w_k = 2*pi*k/M,
lowpass-filtered by the prototype h, and decimated by D (D=M critically,
D=M/2 oversampled):

    y_k[s] = e^{-j w_k n_s} * sum_t h[t] e^{+j w_k t} x[n_s - t],
    n_s = s*D + D - 1.

With t = j*M + rho the inner sum splits into M polyphase branches
u[s, rho] = sum_j h_poly[rho, j] * G[s - (M/D)*j, rho] over reversed
stride-D frames G[s, rho] = x[s*D + D-1 - rho], and the rho-sum is an
M-point inverse DFT. The leading e^{-j w_k n_s} term is a constant phase
c_k per channel (critically sampled) times a (-1)^{k*s} parity flip
(oversampled only). Channel k center frequency: +k/M * fs, wrapped.

Representations: construct with ``dtype=jnp.complex64`` (CPU test path) or
``dtype=PLANAR`` (the receiver's representation — two float32 planes; the
DFT becomes a small real matmul pair). Both run as plain XLA programs: the
PFBCH2 work is J shifted FMAs plus an M-point DFT (M = 6..16), far below
any accelerator's compute/bandwidth balance point, so XLA's fusion of the
FMAs is the whole optimisation.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.stream.op import StreamOp
from cubicsdr.ops import design
from cubicsdr.ops.planar import (
    PC, PLANAR, pc_concat, pc_idft_m, pc_mul)
from cubicsdr.utils.convolve import conv1d_grouped


def _polyphase(h: np.ndarray, M: int) -> np.ndarray:
    """h [M*J] -> h_poly [M, J] with h_poly[rho, j] = h[j*M + rho]."""
    K = len(h)
    J = int(np.ceil(K / M))
    hp = np.zeros((M, J), np.float32)
    for rho in range(M):
        t = h[rho::M]
        hp[rho, : len(t)] = t
    return hp


def _pc_map(f, x):
    """Apply a real array transform to both planes of a PC (or an array)."""
    if isinstance(x, PC):
        return PC(f(x.re), f(x.im))
    return f(x)


class ChannelizerPFB(StreamOp):
    """Critically-sampled M-channel analyzer: L inputs -> [M, L//M] outputs.

    Matches the reference config M channels, 8 taps/branch, 60 dB kaiser
    (ref: src/sdr/SDRPostThread.cpp:406). Input block length must be a
    multiple of M. Output channel k is centered at +k*fs/M (wrapped) and
    sampled at fs/M.
    """

    def __init__(self, num_channels: int, taps_per_channel: int = 8,
                 as_db: float = 60.0, batch_shape: tuple = (),
                 dtype=jnp.complex64):
        self.M = int(num_channels)
        h = design.pfb_prototype(self.M, taps_per_channel, as_db)
        self.h_poly = jnp.asarray(_polyphase(np.asarray(h), self.M))
        self.J = self.h_poly.shape[1]
        self.batch_shape = batch_shape
        self.dtype = dtype
        k = np.arange(self.M)
        # c_k = e^{-j w_k (D-1)} with D = M. Complex jnp constants only on
        # the complex path; the planar path stays real end to end.
        c = np.exp(-2j * np.pi * k * (self.M - 1) / self.M)
        if dtype == PLANAR:
            self.c_pc = PC(jnp.asarray(c.real.astype(np.float32))[:, None],
                           jnp.asarray(c.imag.astype(np.float32))[:, None])
        else:
            self.c = jnp.asarray(c, jnp.complex64)

    def init_state(self):
        # J-1 frames of history, already framed+reversed: [..., M, J-1].
        shape = (*self.batch_shape, self.M, self.J - 1)
        if self.dtype == PLANAR:
            return PC(jnp.zeros(shape, jnp.float32),
                      jnp.zeros(shape, jnp.float32))
        return jnp.zeros(shape, jnp.complex64)

    @property
    def hist_len(self) -> int:
        """Raw-sample history equivalent (for halo exchange)."""
        return (self.J - 1) * self.M

    def hist_from_samples(self, tail):
        """Build the framed history state from the last (J-1)*M raw samples
        (used when history arrives as a time-shard halo)."""
        def f(t):
            G = t.reshape(*t.shape[:-1], self.J - 1, self.M)[..., ::-1]
            return jnp.swapaxes(G, -1, -2)
        return _pc_map(f, tail)

    # Time-sharding: raw-sample tail -> framed history.
    shard_kind = "tail"

    def shard_halo_len(self) -> int:
        return self.hist_len

    def state_from_tail(self, tail):
        return self.hist_from_samples(tail)

    def shard_carry_init(self):
        shape = (*self.batch_shape, self.hist_len)
        if self.dtype == PLANAR:
            return PC(jnp.zeros(shape, jnp.float32),
                      jnp.zeros(shape, jnp.float32))
        return jnp.zeros(shape, jnp.complex64)

    def apply(self, hist, x):
        assert x.shape[-1] % self.M == 0
        n_frames = x.shape[-1] // self.M

        def frames(p):
            # G[s, rho] = x[s*M + M-1 - rho] -> [..., M, s] (branch axis
            # first for the depthwise conv).
            G = p.reshape(*p.shape[:-1], n_frames, self.M)[..., ::-1]
            return jnp.swapaxes(G, -1, -2)

        G = _pc_map(frames, x)
        if isinstance(x, PC):
            z = pc_concat([hist, G])
            u = conv1d_grouped(z, self.h_poly)            # PC [..., M, n]
            # pc_idft_m is M*IDFT (no 1/M) == the complex path's M * ifft.
            y = pc_idft_m(u, axis_m=-2)
            y = pc_mul(y, self.c_pc)
            new_hist = z.slice_last(slice(z.shape[-1] - (self.J - 1), None))
            return new_hist, y
        z = jnp.concatenate([hist, G], axis=-1)
        u = conv1d_grouped(z, self.h_poly)                # [..., M, n_frames]
        y = self.M * jnp.fft.ifft(u, axis=-2)             # DFT over branches
        y = y * self.c[:, None]
        new_hist = z[..., z.shape[-1] - (self.J - 1):]
        return new_hist, y.astype(jnp.complex64)

    def out_shape(self, in_len: int):
        return (self.M, in_len // self.M)


class ChannelizerPFB2(StreamOp):
    """2x-oversampled M-channel analyzer: L inputs -> [M, 2*L//M] outputs.

    Matches liquid firpfbch2 semantics: M outputs per M/2 inputs, channel
    sample rate = 2*fs/M (ref: src/sdr/SDRPostThread.cpp:463,504-509 runs
    demods at chanBw*2). Input block length must be a multiple of M/2.

    Planar option:
      fast_math : unrolled shifted-FMA polyphase FIR (J broadcast FMAs over
                  [M, T] beat the grouped-conv lowering whose M groups of 1
                  channel sit idle).
    """

    def __init__(self, num_channels: int, taps_per_channel: int = 8,
                 as_db: float = 60.0, batch_shape: tuple = (),
                 dtype=jnp.complex64, fast_math: bool = True):
        assert num_channels % 2 == 0
        self.M = int(num_channels)
        self.D = self.M // 2
        h = design.pfb_prototype(self.M, taps_per_channel, as_db)
        self._h_poly_np = _polyphase(np.asarray(h), self.M)
        self.h_poly = jnp.asarray(self._h_poly_np)
        self.J = self.h_poly.shape[1]
        self.batch_shape = batch_shape
        self.dtype = dtype
        self.fast_math = fast_math
        k = np.arange(self.M)
        # c_k = e^{-j w_k (D-1)}, D = M/2.
        c = np.exp(-2j * np.pi * k * (self.D - 1) / self.M)
        if dtype == PLANAR:
            self.c_pc = PC(jnp.asarray(c.real.astype(np.float32))[:, None],
                           jnp.asarray(c.imag.astype(np.float32))[:, None])
        else:
            self.c = jnp.asarray(c, jnp.complex64)
        self.flip = jnp.asarray(np.where(k % 2 == 1, -1.0, 1.0), jnp.float32)
        self._k_par = (k % 2).astype(np.float32)
        # Sample history: oldest sample needed for step s=0 is
        # G[-2(J-1)] window start = -2(J-1)*D - D  ->  (2J-1)*D samples.
        self.hist_len = (2 * self.J - 1) * self.D

    def init_state(self):
        shape = (*self.batch_shape, self.hist_len)
        if self.dtype == PLANAR:
            samp_hist = PC(jnp.zeros(shape, jnp.float32),
                           jnp.zeros(shape, jnp.float32))
        else:
            samp_hist = jnp.zeros(shape, jnp.complex64)
        step_parity = jnp.zeros((), jnp.int32)  # global step count mod 2
        return samp_hist, step_parity

    def _frames(self, z, n_total):
        """Overlapping reversed windows of length M, stride D. Window for
        step s (relative, including history steps) ends at z[s*D + D - 1];
        its M samples reversed give G[s, rho] = z[s*D + D-1 - rho].
        Gather-free framing: a window of length M = 2D at stride D is two
        adjacent D-rows of the reshaped stream (reshape + concat only, no
        [n_total, M] index gather at 1M-sample blocks)."""
        def f(p):
            A = p[..., : (n_total + 1) * self.D].reshape(
                *p.shape[:-1], n_total + 1, self.D)
            G = jnp.concatenate([A[..., :-1, :], A[..., 1:, :]],
                                axis=-1)[..., ::-1]       # [..., n_total, M]
            return jnp.swapaxes(G, -1, -2)                # [..., M, n_total]
        return _pc_map(f, z)

    def _fir(self, G, n_steps):
        """Polyphase FIR over dilation-2 frame windows."""
        if self.fast_math:
            hp = self._h_poly_np

            def fir(plane):
                acc = None
                for j in range(self.J):
                    s0 = 2 * (self.J - 1 - j)
                    term = plane[..., s0: s0 + n_steps] \
                        * jnp.asarray(hp[:, j])[:, None]
                    acc = term if acc is None else acc + term
                return acc

            return _pc_map(fir, G)
        return conv1d_grouped(G, self.h_poly, dilation=2)

    # Time-sharding: state = (raw sample tail, step parity); with an even
    # local step count the parity is shard-invariant (asserted by callers).
    shard_kind = "tail"

    def shard_halo_len(self) -> int:
        return self.hist_len

    def state_from_tail(self, tail):
        return (tail, jnp.zeros((), jnp.int32))

    def shard_carry_init(self):
        return self.init_state()[0]

    def apply(self, state, x):
        samp_hist, parity = state
        assert x.shape[-1] % self.D == 0
        n_steps = x.shape[-1] // self.D
        new_parity = (parity + n_steps) % 2

        if isinstance(x, PC):
            z = pc_concat([samp_hist, x])
            new_hist = z.slice_last(slice(z.shape[-1] - self.hist_len, None))
            n_total = (z.shape[-1] - self.M) // self.D + 1
            G = self._frames(z, n_total)
            u = self._fir(G, n_steps)
            y = pc_idft_m(u, axis_m=-2)
            y = pc_mul(y, self.c_pc)
            # (-1)^{k*s} with global step parity carried across blocks.
            s = ((jnp.arange(n_steps) + parity) % 2).astype(jnp.float32)
            sign = 1.0 - 2.0 * (self._k_par_arr()[:, None] * s[None, :])
            y = PC(y.re * sign, y.im * sign)
            return (new_hist, new_parity), y

        z = jnp.concatenate([samp_hist, x], axis=-1)
        n_total = (z.shape[-1] - self.M) // self.D + 1
        G = self._frames(z, n_total)
        u = conv1d_grouped(G, self.h_poly, dilation=2)    # [..., M, n_steps]
        y = self.M * jnp.fft.ifft(u, axis=-2)
        y = y * self.c[:, None]
        s = (jnp.arange(n_steps) + parity) % 2            # [n_steps]
        sign = jnp.where(s[None, :] == 1, self.flip[:, None], 1.0)
        y = y * sign
        new_hist = z[..., z.shape[-1] - self.hist_len:]
        return (new_hist, new_parity), y.astype(jnp.complex64)

    def _k_par_arr(self):
        return jnp.asarray(self._k_par)

    def out_shape(self, in_len: int):
        return (self.M, 2 * in_len // self.M)


def channel_centers(num_channels: int, sample_rate: float,
                    frequency: float = 0.0) -> np.ndarray:
    """RF center of each channel, matching the analyzer's k -> +k*fs/M
    (wrapped to (-fs/2, fs/2]) ordering. The reference computes the same set
    (plus a duplicated wrap channel) in SDRPostThread::updateChannels
    (ref: src/sdr/SDRPostThread.cpp:100-126)."""
    M = num_channels
    k = np.arange(M)
    f = k * (sample_rate / M)
    f = np.where(f > sample_rate / 2, f - sample_rate, f)
    return frequency + f
