"""Per-demodulator channel frontend: NCO shift + rational resample.

The DemodulatorPreThread analog (ref: src/demod/DemodulatorPreThread.cpp:
153-220): shift each demod's channel by (demodFreq - channelCenter) and
resample channelRate -> modem bandwidth. Batched: N demods = one [N, L]
NCO ramp + one [N]-batched polyphase resampler — a single fused XLA program
instead of N threads.

Shift frequencies are traced scalars: retuning is a new input value, not a
recompile. Changing bandwidth/modem rebuilds the kit (the reference posts
that to a worker thread, ref: DemodulatorPreThread.cpp:105-151; here the
host rebuilds while the old compiled step keeps running).

Planar hot path: the NCO is FOLDED into the first resampler stage's
tap matrix (ops/resample.planar_shifted_resample_matmul) —
``y = e^{-i(φ0+ωn)} Σ h[j]e^{iωj} x[n-j]`` — eliminating the full-rate
phasor generation + complex multiply of a separate mix stage. The
modulated tap matrix depends only on the control input ω, so XLA hoists
it out of the per-block dispatch scan.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.ops.nco import NCOMixer
from cubicsdr.ops.planar import PC, PLANAR, xcat, xtail
from cubicsdr.ops.resample import (
    IdentityResampler, RationalResampler, ResamplerChain, design_ratio,
    make_resampler, planar_shifted_resample_conv,
    planar_shifted_resample_matmul)
from cubicsdr.stream.op import StreamOp

TWO_PI = 6.283185307179586

# Route formulation for the folded mix+resample stage:
# "matmul" = banded-Toeplitz windows (materializes [N, rows, W] +
# [N, W, O] in device memory), "conv" = grouped strided conv with
# per-demod modulated kernels (reads only the gathered stream). Override
# with CUBICSDR_XLA_ROUTE=matmul|conv.
import os as _os
XLA_ROUTE_FORM = _os.environ.get("CUBICSDR_XLA_ROUTE", "matmul")


class ChannelFrontend(StreamOp):
    """(state, (x[..., N, L], omega[N])) -> (state, y[..., N, Lout]).

    ``omega`` = 2*pi*(channelCenter - demodFreq)/channelRate per demod (the
    mix-down sign convention of DemodulatorPreThread.cpp:153-195: shifting
    the wanted carrier to DC).
    """

    # Class-level default for the folded-NCO fast path (perf A/B knob).
    FOLD_NCO = True

    def __init__(self, channel_rate: float, bandwidth: float,
                 n_demods: int, batch_shape: tuple = (),
                 dtype=jnp.complex64, fold: bool | None = None):
        self.channel_rate = float(channel_rate)
        self.bandwidth = float(bandwidth)
        bs = (*batch_shape, n_demods)
        self.bs = bs
        self.nco = NCOMixer(bs)
        P, Q = design_ratio(bandwidth / channel_rate, max_denominator=500)
        self.P, self.Q = P, Q
        self.dtype = dtype
        self.resampler = make_resampler(P, Q, batch_shape=bs, dtype=dtype)
        # Folded-NCO fast path applies when planar and the first stage is a
        # tiled RationalResampler (ops/resample.py); otherwise mix-then-
        # resample.
        self._stage1 = (self.resampler.stages[0]
                        if isinstance(self.resampler, ResamplerChain)
                        else self.resampler)
        self._rest = (self.resampler.stages[1:]
                      if isinstance(self.resampler, ResamplerChain) else [])
        if fold is None:
            fold = ChannelFrontend.FOLD_NCO
        self.folded = (fold and dtype == PLANAR
                       and isinstance(self._stage1, RationalResampler))

    @property
    def block_multiple(self) -> int:
        return self.Q

    def out_len(self, in_len: int) -> int:
        return in_len // self.Q * self.P

    def init_state(self):
        if self.folded:
            return (self.nco.init_state(),          # phase at fresh x[0]
                    self._stage1.init_state(),      # RAW input tail
                    tuple(s.init_state() for s in self._rest))
        return (self.nco.init_state(), self.resampler.init_state())

    def _folded_core(self, z, omega, phase0):
        """Folded mix+resample on a hist-prefixed RAW stream ``z``; phase0
        is the phase at the first FRESH sample (z[hist_len]). Falls back to
        classic mix-then-conv when no output tile divides (small test
        blocks) — identical math, same raw-history state layout."""
        rs = self._stage1
        # Phase of window sample w[0]: w = z[start:], z[t] is at global
        # phase phase0 + omega*(t - hist_len).
        start_off = rs.Q - rs.KK                   # start - hist_len
        phase_w0 = jnp.mod(phase0 + omega * start_off, TWO_PI)
        if XLA_ROUTE_FORM == "conv" and z.re.ndim == 2:
            return planar_shifted_resample_conv(z, rs, omega, phase_w0)
        y = planar_shifted_resample_matmul(z, rs, omega, phase_w0)
        if y is None:
            from cubicsdr.ops.resample import planar_rational_resample
            k = (jnp.arange(z.shape[-1], dtype=jnp.float32)
                 - jnp.float32(rs.hist_len))
            th = jnp.mod(phase0[..., None] + omega[..., None] * k, TWO_PI)
            c, s = jnp.cos(th), jnp.sin(th)
            zm = PC(z.re * c - z.im * s, z.im * c + z.re * s)
            y = planar_rational_resample(zm, rs)
        return y

    def apply(self, state, inputs):
        x, omega = inputs
        if self.folded:
            phase0, hist, rest = state
            omega = jnp.asarray(omega, jnp.float32)
            z = xcat([hist, x])
            y = self._folded_core(z, omega, phase0)
            new_hist = xtail(z, self._stage1.hist_len)
            new_phase = jnp.mod(phase0 + omega * x.shape[-1], TWO_PI)
            new_rest = []
            for s_i, st_i in zip(self._rest, rest):
                st_i, y = s_i.apply(st_i, y)
                new_rest.append(st_i)
            return (new_phase, new_hist, tuple(new_rest)), y
        s_n, s_r = state
        s_n, y = self.nco.apply(s_n, (x, omega))
        s_r, y = self.resampler.apply(s_r, y)
        return (s_n, s_r), y

    # --- time-sharding: NCO phase is closed-form in the shard index (no
    # collective); the resampler halo-exchanges its input tail. Planar-only
    # (the sharded receiver runs the planar representation). ---
    def shard_carries(self):
        if self.folded:
            return (self.nco.init_state(),
                    self._stage1.shard_carry_init(),
                    tuple(s.shard_carry_init() for s in self._rest))
        return (self.nco.init_state(), self.resampler.shard_carries())

    def shard_apply(self, carries, inputs, axis):
        from cubicsdr.parallel.halo import streaming_halo
        from cubicsdr.parallel.shardable import nco_shard_mix
        x, omega = inputs
        if self.folded:
            base, c1, c_rest = carries
            omega = jnp.asarray(omega, jnp.float32)
            L = x.shape[-1]
            t = jnp.asarray(jax.lax.axis_index(axis), jnp.float32)
            n_t = jnp.float32(jax.lax.psum(1, axis))
            phase0 = jnp.mod(base + omega * (t * L), TWO_PI)
            rs = self._stage1
            z, new_c1 = streaming_halo(x, rs.hist_len, c1, axis)
            y = self._folded_core(z, omega, phase0)
            new_base = jnp.mod(base + omega * (n_t * L), TWO_PI)
            new_rest = []
            for s_i, st_i in zip(self._rest, c_rest):
                st_i, y = _shard_tail_stage(s_i, st_i, y, axis)
                new_rest.append(st_i)
            return (new_base, new_c1, tuple(new_rest)), y
        base, c_r = carries
        base, y = nco_shard_mix(base, jnp.asarray(omega, jnp.float32),
                                x, axis)
        c_r, y = self.resampler.shard_apply(c_r, y, axis)
        return (base, c_r), y


def _shard_tail_stage(op, carry, x, axis):
    from cubicsdr.parallel.shardable import shard_stage
    return shard_stage(op, carry, x, axis)


def shift_omegas(demod_freqs, channel_centers, channel_rate):
    """omega[i] = 2*pi*(center_i - freq_i)/rate — mix the offset down to DC.

    Matches the reference's shiftFrequency = demodFreq - channelCenter with
    mix up/down by sign (DemodulatorPreThread.cpp:153-195); expressed here as
    one signed NCO frequency.
    """
    df = jnp.asarray(channel_centers, jnp.float32) - jnp.asarray(
        demod_freqs, jnp.float32)
    return 2.0 * jnp.pi * df / channel_rate
