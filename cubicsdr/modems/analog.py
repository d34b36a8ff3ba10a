"""Analog modem bank: FM, NBFM, FM-stereo, AM, DSB, USB, LSB, CW, IQ.

Parity map (all ref paths under src/modules/modem/analog/):
  FM / NBFM : freqdem kf=0.5 (ModemFM.cpp:7,36; ModemNBFM.cpp)
  FMStereo  : freqdem + 19 kHz pilot recovery + 38 kHz DSB subcarrier
              + 0.568*(M -/+ S) matrix + optional de-emphasis + 16 kHz LPF
              (ModemFMStereo.cpp:100-300). Re-design: the per-sample PLL
              is replaced by *pilot squaring* — an analytic pilot bandpass
              whose normalized square is exactly the 38 kHz reference; no
              sequential loop, same recovered audio.
  AM        : envelope + 51-tap FIR DC blocker, autoGain (ModemAM.cpp:7-48)
  DSB       : suppressed-carrier product detect; block-level squaring carrier
              recovery replaces liquid ampmodem's PLL (ModemDSB.cpp)
  USB / LSB : one-sided complex FIR bandpass + Re{.} replaces the quarter-rate
              shift + IIR halfband + firhilbf chain (ModemUSB.cpp:7-60)
  CW        : beep-frequency NCO offset + Re{.}, gain/autoGain (ModemCW.cpp)
  IQ        : stereo passthrough (imag, real) (ModemIQ.cpp:31-57)

Each kit is a StreamOp: (state, iq[..., L]) -> (state, audio[..., C, Lout]).

Representation: every kit is *planes-first* — the IQ input may be complex64
(CPU tests) or planar PC (the receiver's representation), and the demod
math runs on real (re, im) planes either way.
``build_kit(..., dtype=PLANAR)`` selects planar state for the stages that
carry complex history (resamplers, freqdem prev-sample).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.modems.base import (
    Modem, ModemArg, register_modem, MIN_BANDWIDTH, DEFAULT_AUDIO_RATE)
from cubicsdr.ops import design
from cubicsdr.ops.agc import AutoGain
from cubicsdr.ops.fir import FirFilter, DelayLine, fir_block
from cubicsdr.ops.freqdem import FreqDem
from cubicsdr.ops.iir import FirstOrderIIR
from cubicsdr.ops.nco import NCOMixer
from cubicsdr.ops.planar import planes_of
from cubicsdr.ops.resample import make_resampler, design_ratio
from cubicsdr.stream.op import StreamOp


def _audio_ratio(sample_rate: int, audio_rate: int):
    return design_ratio(audio_rate / sample_rate, max_denominator=500)


class AnalogKit(StreamOp):
    """Shared analog plumbing: demod -> (autoGain) -> audio resample.

    Mirrors ModemAnalog::buildKit/buildAudioOutput (ref: ModemAnalog.cpp:21-33,
    67-93): msresamp_rrrf at 60 dB becomes a RationalResampler; autoGain is
    the same double-EMA of the pre-gain ceiling.
    """

    def __init__(self, demod: StreamOp, sample_rate: int, audio_rate: int,
                 auto_gain: bool, batch_shape: tuple = (),
                 post: StreamOp | None = None,
                 time_axis: str | None = None):
        self.demod = demod
        P, Q = _audio_ratio(sample_rate, audio_rate)
        self.P, self.Q = P, Q
        self.resampler = make_resampler(P, Q, batch_shape=batch_shape,
                                        dtype=jnp.float32)
        self.agc = (AutoGain(batch_shape=batch_shape, time_axis=time_axis)
                    if auto_gain else None)
        self.post = post
        self.audio_rate = audio_rate

    def init_state(self):
        return (self.demod.init_state(),
                self.agc.init_state() if self.agc else (),
                self.resampler.init_state(),
                self.post.init_state() if self.post else ())

    def apply(self, state, x):
        sd, sa, sr, sp = state
        sd, a = self.demod.apply(sd, x)
        if self.agc:
            sa, a = self.agc.apply(sa, a)
        sr, a = self.resampler.apply(sr, a)
        if self.post:
            sp, a = self.post.apply(sp, a)
        return (sd, sa, sr, sp), a[..., None, :]   # mono channel axis

    # --- time-sharding: demod core by its own kind, AGC replicated
    # (collective ceiling via time_axis), audio resampler halo on the
    # demodulated signal. ---
    def shard_carries(self):
        assert self.post is None, "post stage not shardable"
        return (self.demod.shard_carries(),
                self.agc.init_state() if self.agc else (),
                self.resampler.shard_carries())

    def shard_apply(self, carries, x, axis):
        cd, sa, cr = carries
        cd, a = self.demod.shard_apply(cd, x, axis)
        if self.agc:
            sa, a = self.agc.apply(sa, a)
        cr, a = self.resampler.shard_apply(cr, a, axis)
        return (cd, sa, cr), a[..., None, :]


class _AnalogModem(Modem):
    auto_gain = False

    def block_multiple(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE):
        _, Q = _audio_ratio(sample_rate, audio_rate)
        return Q

    def _demod_op(self, sample_rate, audio_rate, batch_shape, dtype,
                  time_axis=None):
        raise NotImplementedError

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=jnp.complex64, time_axis=None):
        return AnalogKit(
            self._demod_op(sample_rate, audio_rate, batch_shape, dtype,
                           time_axis),
            sample_rate, audio_rate, self.auto_gain, batch_shape,
            time_axis=time_axis)


@register_modem
class ModemFM(_AnalogModem):
    name = "FM"
    default_sample_rate = 200000

    def _demod_op(self, sample_rate, audio_rate, batch_shape, dtype,
                  time_axis=None):
        return FreqDem(kf=0.5, batch_shape=batch_shape, dtype=dtype)


@register_modem
class ModemNBFM(_AnalogModem):
    name = "NBFM"
    default_sample_rate = 12500

    def _demod_op(self, sample_rate, audio_rate, batch_shape, dtype,
                  time_axis=None):
        return FreqDem(kf=0.5, batch_shape=batch_shape, dtype=dtype)


class _EnvelopeDC(StreamOp):
    """|IQ| envelope -> FIR DC blocker (delta minus narrow lowpass), the AM
    detector (ref: ModemAM.cpp:7-10,40-48: 25-wide dc blocker, 30 dB)."""

    def __init__(self, batch_shape=(), dtype=jnp.complex64):
        n = 51
        lp = design.kaiser_lowpass(n, 0.004, 30.0)
        lp = lp / lp.sum()
        h = -lp
        h[(n - 1) // 2] += 1.0
        self.fir = FirFilter(h, batch_shape, dtype=jnp.float32)
        self.batch_shape = batch_shape
        self.dtype = dtype
        self._k = n

    def init_state(self):
        return self.fir.init_state()

    def apply(self, state, x):
        re, im = planes_of(x)
        env = jnp.sqrt(re * re + im * im)
        return self.fir.apply(state, env)

    # Time-sharding: the FIR history is the envelope of the input tail
    # (|.| is memoryless), so the halo is the raw IQ tail.
    shard_kind = "tail"

    def shard_halo_len(self) -> int:
        return self._k - 1

    def state_from_tail(self, tail):
        re, im = planes_of(tail)
        return jnp.sqrt(re * re + im * im)

    def shard_carry_init(self):
        from cubicsdr.ops.planar import dtype_zeros
        return dtype_zeros((*self.batch_shape, self._k - 1), self.dtype)


@register_modem
class ModemAM(_AnalogModem):
    name = "AM"
    default_sample_rate = 6000
    auto_gain = True

    def uses_signal_output(self):
        return True

    def _demod_op(self, sample_rate, audio_rate, batch_shape, dtype,
                  time_axis=None):
        return _EnvelopeDC(batch_shape, dtype=dtype)


class _DSBDemod(StreamOp):
    """Suppressed-carrier coherent detect with block squaring carrier recovery:
    phi2 = EMA of arg(mean(x^2)); y = Re{x * exp(-j*phi2/2)}."""

    # Time-sharding: the carrier EMA is block-granular; with time_axis set
    # the block mean becomes a pmean so the state stays replicated.
    shard_kind = "replicated"

    def __init__(self, batch_shape=(), rate=0.2, time_axis=None):
        self.batch_shape = batch_shape
        self.rate = rate
        self.time_axis = time_axis

    def init_state(self):
        return jnp.zeros((*self.batch_shape, 2), jnp.float32)  # smoothed c2 vec

    def apply(self, c2, x):
        re, im = planes_of(x)
        m2r = jnp.mean(re * re - im * im, axis=-1)
        m2i = jnp.mean(2.0 * re * im, axis=-1)
        if self.time_axis is not None:
            m2r = jax.lax.pmean(m2r, self.time_axis)
            m2i = jax.lax.pmean(m2i, self.time_axis)
        vec = jnp.stack([m2r, m2i], axis=-1)
        c2 = c2 + (vec - c2) * self.rate
        phi2 = jnp.arctan2(c2[..., 1], c2[..., 0])
        cr = jnp.cos(-0.5 * phi2)[..., None]
        ci = jnp.sin(-0.5 * phi2)[..., None]
        return c2, (re * cr - im * ci).astype(jnp.float32)


@register_modem
class ModemDSB(_AnalogModem):
    name = "DSB"
    default_sample_rate = 5400
    auto_gain = True

    def uses_signal_output(self):
        return True

    def _demod_op(self, sample_rate, audio_rate, batch_shape, dtype,
                  time_axis=None):
        return _DSBDemod(batch_shape, time_axis=time_axis)


class _SSBDemod(StreamOp):
    """One-sided complex-tap FIR -> Re{.}. Planes-first: Re{conv(x, h)} =
    conv(re, h.re) - conv(im, h.im) — exactly TWO real convolutions (the
    complex form would lower to four)."""

    def __init__(self, sample_rate, upper: bool, batch_shape=(),
                 dtype=jnp.complex64):
        taps_len = min(257, design.kaiser_filter_len(
            max(200.0 / sample_rate, 0.002), 60.0) | 1)
        h = np.asarray(design.ssb_bandpass(taps_len, sample_rate, sample_rate,
                                           upper=upper))
        self.h_re = h.real.astype(np.float32)
        self.h_im = h.imag.astype(np.float32)
        self.k = len(h)
        self.batch_shape = batch_shape
        self.dtype = dtype

    def init_state(self):
        shape = (*self.batch_shape, self.k - 1)
        return (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))

    def apply(self, state, x):
        hr, hi = state
        re, im = planes_of(x)
        hr, yr = fir_block(hr, re, self.h_re)
        hi, yi = fir_block(hi, im, self.h_im)
        return (hr, hi), yr - yi

    # Time-sharding: state = planes of the input tail.
    shard_kind = "tail"

    def shard_halo_len(self) -> int:
        return self.k - 1

    def state_from_tail(self, tail):
        return planes_of(tail)

    def shard_carry_init(self):
        from cubicsdr.ops.planar import dtype_zeros
        return dtype_zeros((*self.batch_shape, self.k - 1), self.dtype)


def _even_rate(sample_rate, audio_rate):
    r = max(int(sample_rate), MIN_BANDWIDTH)
    return r if r % 2 == 0 else r + 1


@register_modem
class ModemUSB(_AnalogModem):
    name = "USB"
    default_sample_rate = 5400
    auto_gain = True
    check_sample_rate = classmethod(
        lambda cls, sr, ar: _even_rate(sr, ar))

    def uses_signal_output(self):
        return True

    def _demod_op(self, sample_rate, audio_rate, batch_shape, dtype,
                  time_axis=None):
        return _SSBDemod(sample_rate, upper=True, batch_shape=batch_shape,
                         dtype=dtype)


@register_modem
class ModemLSB(_AnalogModem):
    name = "LSB"
    default_sample_rate = 5400
    auto_gain = True
    check_sample_rate = classmethod(
        lambda cls, sr, ar: _even_rate(sr, ar))

    def uses_signal_output(self):
        return True

    def _demod_op(self, sample_rate, audio_rate, batch_shape, dtype,
                  time_axis=None):
        return _SSBDemod(sample_rate, upper=False, batch_shape=batch_shape,
                         dtype=dtype)


class _CWKit(StreamOp):
    """CW: interpolate the narrow IQ segment up to the audio rate, offset by
    the beep frequency, take the real part and apply gain/autoGain — the
    reference's exact order (ref: ModemCW.cpp:110-190: msresamp_cccf to the
    audio rate first, since a 500 Hz-wide stream cannot carry a 650 Hz beep).
    """

    def __init__(self, sample_rate, audio_rate, beep_hz=650.0, gain=15.0,
                 auto=True, batch_shape=(), dtype=jnp.complex64,
                 time_axis=None):
        P, Q = _audio_ratio(sample_rate, audio_rate)
        self.up = make_resampler(P, Q, batch_shape=batch_shape, dtype=dtype)
        self.omega = 2 * np.pi * beep_hz / audio_rate
        self.gain = gain
        self.nco = NCOMixer(batch_shape)
        self.agc = (AutoGain(batch_shape=batch_shape, time_axis=time_axis)
                    if auto else None)
        self.batch_shape = batch_shape

    def init_state(self):
        return (self.up.init_state(), self.nco.init_state(),
                self.agc.init_state() if self.agc else ())

    def apply(self, state, x):
        s_up, s_n, s_a = state
        s_up, y = self.up.apply(s_up, x)
        s_n, y = self.nco.apply(s_n, (y, self.omega))
        re, _ = planes_of(y)
        a = (re * self.gain).astype(jnp.float32)
        if self.agc:
            s_a, a = self.agc.apply(s_a, a)
        return (s_up, s_n, s_a), a[..., None, :]

    # Time-sharding: resampler halo; beep NCO phase is closed-form in the
    # shard index; AGC replicated.
    def shard_carries(self):
        return (self.up.shard_carries(),
                jnp.zeros(self.batch_shape, jnp.float32),
                self.agc.init_state() if self.agc else ())

    def shard_apply(self, carries, x, axis):
        from cubicsdr.ops.planar import PC
        from cubicsdr.parallel.shardable import nco_shard_mix
        c_up, base, s_a = carries
        c_up, y = self.up.shard_apply(c_up, x, axis)
        omega = jnp.full(self.batch_shape, self.omega, jnp.float32)
        if isinstance(y, PC):
            base, y = nco_shard_mix(base, omega, y, axis)
            a = y.re * np.float32(self.gain)
        else:
            raise NotImplementedError("sharded CW is planar-only")
        if self.agc:
            s_a, a = self.agc.apply(s_a, a)
        return (c_up, base, s_a), a[..., None, :]


@register_modem
class ModemCW(_AnalogModem):
    name = "CW"
    default_sample_rate = MIN_BANDWIDTH
    auto_gain = True

    def get_settings(self):
        return [
            ModemArg("offset", "Frequency Offset", 650.0, "float", "Hz",
                     "Frequency Offset / Beep frequency (200-1000Hz)",
                     200.0, 1000.0),
            ModemArg("auto", "Auto Gain", "on", "string",
                     options=["on", "off"]),
            ModemArg("gain", "Gain", 15.0, "float", low=1.0, high=100.0),
        ]

    def uses_signal_output(self):
        return True

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=jnp.complex64, time_axis=None):
        return _CWKit(sample_rate, audio_rate,
                      float(self.settings["offset"]),
                      float(self.settings["gain"]),
                      str(self.settings["auto"]) == "on", batch_shape, dtype,
                      time_axis)


class _IQKit(StreamOp):
    """Stereo passthrough: (left, right) = (imag, real)
    (ref: ModemIQ.cpp:39-57)."""

    shard_kind = "stateless"

    def apply(self, state, x):
        re, im = planes_of(x)
        audio = jnp.stack([im, re], axis=-2).astype(jnp.float32)
        return state, audio


@register_modem
class ModemIQ(Modem):
    name = "I/Q"
    modem_type = "analog"
    default_sample_rate = 48000

    @classmethod
    def check_sample_rate(cls, sample_rate, audio_rate):
        # Bandwidth pinned to the audio rate (ref: ModemIQ.cpp:31-33).
        return int(audio_rate)

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=jnp.complex64, time_axis=None):
        return _IQKit()


class _FMStereoKit(StreamOp):
    """FM stereo decoder; see module docstring for the pilot-squaring design.

    Chain: freqdem -> { mono M ; analytic pilot p via one-sided 19 kHz FIR
    bandpass ; S = Im[LPF( m * conj(p^2/|p|^2) )] } -> resample M,S ->
    L,R = 0.568*(M -/+ S) -> optional de-emphasis -> 16 kHz kaiser LPF pair
    (ref: ModemFMStereo.cpp:100-121 for the LPF spec, 271-299 for the matrix).

    Everything after the discriminator is REAL math: the analytic pilot is
    two real FIRs (re/im of the one-sided taps on the real composite), and
    because the S-subcarrier LPF has real taps, Im{LPF(v)} = LPF(Im{v}) —
    only the imaginary plane of the down-mixed subcarrier is ever filtered.
    No complex arrays anywhere: the same real-plane program on every backend.
    """

    def __init__(self, sample_rate, audio_rate, demph_us, batch_shape=(),
                 dtype=jnp.complex64):
        bs = batch_shape
        self.freqdem = FreqDem(0.5, bs, dtype=dtype)
        # Analytic pilot bandpass: one-sided complex FIR centered at +19 kHz,
        # +-500 Hz passband (ref pilot: cheby2 bandpass 19000..19500,
        # ModemFMStereo.cpp:126-135). Split into re/im real tap sets.
        n = design.kaiser_filter_len(1000.0 / sample_rate, 60.0) | 1
        n = min(n, 1023)
        lp = design.kaiser_lowpass(n, 500.0 / sample_rate, 60.0)
        t = np.arange(n) - (n - 1) / 2
        hp = 2.0 * lp * np.exp(2j * np.pi * 19000.0 / sample_rate * t)
        self.hp_re = hp.real.astype(np.float32)
        self.hp_im = hp.imag.astype(np.float32)
        self.n_pilot = n
        self.bs = bs
        # Real LPF extracting the down-mixed S plane (15 kHz wide).
        ns = design.kaiser_filter_len(4000.0 / sample_rate, 60.0) | 1
        hs = design.kaiser_lowpass(ns, 16000.0 / sample_rate, 60.0)
        self.s_fir = FirFilter(hs, bs, dtype=jnp.float32)
        # Align the composite with the pilot filter's group delay before
        # mixing with the squared-pilot reference (otherwise the 38 kHz
        # reference is phase-rotated by 2*w_p*delay and separation collapses),
        # then give the mono path the S-LPF's delay on top.
        self.pre_delay = DelayLine((n - 1) // 2, bs, jnp.float32)
        self.mono_delay = DelayLine((ns - 1) // 2, bs, jnp.float32)
        P, Q = _audio_ratio(sample_rate, audio_rate)
        self.Q = Q
        self.rs_mono = make_resampler(P, Q, batch_shape=bs,
                                      dtype=jnp.float32)
        self.rs_st = make_resampler(P, Q, batch_shape=bs,
                                    dtype=jnp.float32)
        # Audio-rate stereo post chain (batch gains a channel axis of 2).
        self.demph = None
        if demph_us:
            b, a = design.deemphasis_coeffs(demph_us, audio_rate)
            self.demph = FirstOrderIIR(b, a, batch_shape=(*bs, 2))
        fc = min(max(16000.0 / audio_rate, 0.0), 0.5)
        na = design.kaiser_filter_len(1000.0 / audio_rate, 60.0) | 1
        ha = design.kaiser_lowpass(na, fc, 60.0)
        self.audio_fir = FirFilter(ha, (*bs, 2), dtype=jnp.float32)

    def init_state(self):
        np_hist = (*self.bs, self.n_pilot - 1)
        return (self.freqdem.init_state(),
                (jnp.zeros(np_hist, jnp.float32),
                 jnp.zeros(np_hist, jnp.float32)),      # pilot re/im hists
                self.pre_delay.init_state(), self.s_fir.init_state(),
                self.mono_delay.init_state(),
                self.rs_mono.init_state(), self.rs_st.init_state(),
                self.demph.init_state() if self.demph else (),
                self.audio_fir.init_state())

    def apply(self, state, x):
        s_fd, (s_pr, s_pi), s_pd, s_s, s_md, s_rm, s_rs, s_de, s_af = state
        s_fd, m = self.freqdem.apply(s_fd, x)
        # Analytic pilot (two real FIRs) & 38 kHz reference by squaring.
        s_pr, pr = fir_block(s_pr, m, self.hp_re)
        s_pi, pi = fir_block(s_pi, m, self.hp_im)
        p2r = pr * pr - pi * pi
        p2i = 2.0 * pr * pi
        mag = jnp.sqrt(p2r * p2r + p2i * p2i) + 1e-12
        ref_r, ref_i = p2r / mag, p2i / mag
        # Composite delayed to match the pilot path's group delay.
        s_pd, m_al = self.pre_delay.apply(s_pd, m)
        # Down-mix the 38 kHz DSB subcarrier to DC; S = Im after real-tap
        # LPF = LPF(Im{m_al * conj(ref)}) = LPF(-m_al * ref_i).
        s_s, z_im = self.s_fir.apply(s_s, -m_al * ref_i)
        s_band = 2.0 * z_im
        s_md, m_d = self.mono_delay.apply(s_md, m_al)
        s_rm, mono = self.rs_mono.apply(s_rm, m_d)
        s_rs, ster = self.rs_st.apply(s_rs, s_band)
        # Pilot-squaring recovers S = (L-R)*k with positive sign, so left is
        # mono+S here (the reference's PLL chain lands on the opposite sign,
        # hence its mono-minus form at ModemFMStereo.cpp:283-293).
        left = 0.568 * (mono + ster)
        right = 0.568 * (mono - ster)
        lr = jnp.stack([left, right], axis=-2)
        if self.demph:
            s_de, lr = self.demph.apply(s_de, lr)
        s_af, lr = self.audio_fir.apply(s_af, lr)
        return ((s_fd, (s_pr, s_pi), s_pd, s_s, s_md, s_rm, s_rs, s_de,
                 s_af), lr.astype(jnp.float32))


@register_modem
class ModemFMStereo(Modem):
    name = "FMS"
    modem_type = "analog"
    # Carson bandwidth of a 75 kHz-deviation stereo multiplex (53 kHz
    # top edge) is ~256 kHz: a 200 kHz channel truncates the FM sidebands
    # and caps separation at ~27 dB; 250 kHz restores broadcast-grade
    # 34 dB (measured through the full pipeline; receiver/fidelity.py).
    default_sample_rate = 250000

    def get_settings(self):
        return [ModemArg("demph", "De-emphasis", 75, "int", "us",
                         "De-emphasis time constant", options=[0, 10, 25, 50, 75])]

    @classmethod
    def check_sample_rate(cls, sample_rate, audio_rate):
        # Needs the 38 kHz subcarrier: force >= 100 kHz
        # (ref: ModemFMStereo.cpp:27-34).
        return max(int(sample_rate), 100000)

    def block_multiple(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE):
        _, Q = _audio_ratio(sample_rate, audio_rate)
        return Q

    def build_kit(self, sample_rate, audio_rate=DEFAULT_AUDIO_RATE,
                  batch_shape=(), dtype=jnp.complex64, time_axis=None):
        return _FMStereoKit(sample_rate, audio_rate,
                            int(self.settings["demph"]), batch_shape, dtype)
