"""Golden tests: kernel library vs scipy reference + streaming==batch
equivalence (SURVEY.md §4 items 1-2)."""

import numpy as np
import scipy.signal as sps
import jax
import jax.numpy as jnp
import pytest

from cubicsdr.ops.nco import NCOMixer, mix
from cubicsdr.ops.fir import FirFilter, FirDecimator
from cubicsdr.ops.iir import DCBlocker, SOSFilter, FirstOrderIIR
from cubicsdr.ops.freqdem import FreqDem
from cubicsdr.ops.resample import RationalResampler, design_ratio
from cubicsdr.ops import design
from cubicsdr.stream.op import scan_blocks, split_blocks


def run_stream(op, x, block_len):
    """Stream x through op block-by-block; return concatenated output."""
    blocks = split_blocks(jnp.asarray(x), block_len)
    state = op.init_state()
    _, ys = scan_blocks(op, state, blocks)
    return np.asarray(ys).reshape(-1, *ys.shape[2:]).reshape(-1) \
        if ys.ndim == 2 else np.asarray(ys).reshape(-1)


class TestNCO:
    def test_matches_closed_form_and_is_continuous(self, rng):
        n, fs, fshift = 4096, 1e6, 123456.0
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64)
        omega = 2 * np.pi * fshift / fs
        expected = x * np.exp(1j * omega * np.arange(n))

        op = NCOMixer()
        state = op.init_state()
        outs = []
        for blk in x.reshape(8, -1):
            state, y = op.apply(state, (jnp.asarray(blk), omega))
            outs.append(np.asarray(y))
        got = np.concatenate(outs)
        np.testing.assert_allclose(got, expected, atol=2e-3)

    def test_batch_phases_independent(self, rng):
        op = NCOMixer(batch_shape=(4,))
        x = jnp.ones((4, 256), jnp.complex64)
        omegas = jnp.asarray([0.1, 0.2, 0.3, 0.4])
        state = op.init_state()
        state, y = op.apply(state, (x, omegas))
        for i, w in enumerate([0.1, 0.2, 0.3, 0.4]):
            np.testing.assert_allclose(
                np.asarray(y[i]), np.exp(1j * w * np.arange(256)), atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(state), np.mod(np.asarray(omegas) * 256, 2 * np.pi),
            atol=1e-3)


class TestFIR:
    def test_streaming_equals_lfilter(self, rng):
        h = design.kaiser_lowpass(63, 0.1)
        x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
             ).astype(np.complex64)
        expected = sps.lfilter(h, 1.0, x)
        got = run_stream(FirFilter(h), x, 512)
        np.testing.assert_allclose(got, expected, atol=1e-4)

    @pytest.mark.parametrize("decim", [2, 4, 8])
    def test_decimator_matches_strided_lfilter(self, rng, decim):
        h = design.kaiser_lowpass(64, 0.4 / decim)
        x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
             ).astype(np.complex64)
        expected = sps.lfilter(h, 1.0, x)[::decim]
        got = run_stream(FirDecimator(h, decim), x, 512)
        np.testing.assert_allclose(got, expected, atol=1e-4)


class TestIIR:
    def test_dc_blocker_removes_dc(self, rng):
        x = (rng.standard_normal(8192) + 1j * rng.standard_normal(8192)
             + (3.0 + 1j)).astype(np.complex64)
        y = run_stream(DCBlocker(alpha=0.005), x, 1024)
        # Steady-state mean ~ 0.
        assert abs(np.mean(y[4096:])) < 0.05
        # Matches scipy lfilter with the same transfer function.
        expected = sps.lfilter([1.0, -1.0], [1.0, -(1 - 0.005)], x)
        np.testing.assert_allclose(y, expected, atol=1e-3)

    def test_sos_matches_scipy(self, rng):
        sos = sps.butter(6, 0.3, output="sos")
        x = rng.standard_normal(4096).astype(np.float32)
        expected = sps.sosfilt(sos, x)
        got = run_stream(SOSFilter(sos), x, 512)
        np.testing.assert_allclose(got, expected, atol=1e-3)

    def test_first_order_matches_scipy(self, rng):
        b, a = design.deemphasis_coeffs(75.0, 48000.0)
        x = rng.standard_normal(4096).astype(np.float32)
        expected = sps.lfilter(b, a, x)
        got = run_stream(FirstOrderIIR(b, a), x, 512)
        np.testing.assert_allclose(got, expected, atol=1e-4)


class TestFreqDem:
    def test_recovers_fm_tone(self):
        fs, dev, f_audio = 200e3, 75e3, 1e3
        n = 1 << 14
        t = np.arange(n) / fs
        msg = np.sin(2 * np.pi * f_audio * t)
        phase = 2 * np.pi * dev * np.cumsum(msg) / fs
        x = np.exp(1j * phase).astype(np.complex64)

        audio = run_stream(FreqDem(kf=0.5), x, 2048)
        # Output scale: d_phase/(2*pi*kf) = (2*pi*dev*msg/fs)/pi = 2*dev/fs*msg
        expected = 2 * dev / fs * msg
        np.testing.assert_allclose(audio[1:], expected[1:], atol=1e-3)


class TestResampler:
    @pytest.mark.parametrize("P,Q", [(6, 25), (2, 3), (3, 1), (1, 4), (5, 7)])
    def test_matches_upfirdn(self, rng, P, Q):
        op = RationalResampler(P, Q, dtype=jnp.float32)
        n_blocks, L = 6, 50 * Q
        x = rng.standard_normal(n_blocks * L).astype(np.float32)
        expected = sps.upfirdn(np.asarray(op.h), x, up=P, down=Q)

        state = op.init_state()
        outs = []
        for blk in x.reshape(n_blocks, L):
            state, y = op.apply(state, jnp.asarray(blk))
            outs.append(np.asarray(y))
        got = np.concatenate(outs)
        np.testing.assert_allclose(got, expected[: len(got)], atol=1e-4)

    def test_complex_tone_preserved(self, tone):
        # 200 kHz -> 48 kHz, the FM audio resample config.
        P, Q = design_ratio(48000 / 200000)
        assert (P, Q) == (6, 25)
        op = RationalResampler(P, Q)
        fs, f0 = 200e3, 5e3
        x = tone(25 * 2048, f0, fs)
        state = op.init_state()
        outs = []
        for blk in x.reshape(-1, 25 * 256):
            state, y = op.apply(state, jnp.asarray(blk))
            outs.append(np.asarray(y))
        y = np.concatenate(outs)[500:]
        # Tone should land at f0 in the 48 kHz output with unity-ish gain.
        spec = np.fft.fft(y * np.hanning(len(y)))
        fpk = abs(np.fft.fftfreq(len(y), 1 / 48000)[np.argmax(np.abs(spec))])
        assert abs(fpk - f0) < 48000 / len(y) * 2
        assert abs(np.abs(y).mean() - 1.0) < 0.05

    def test_design_ratio_exact(self):
        assert design_ratio(0.5) == (1, 2)
        assert design_ratio(48000 / 200000) == (6, 25)


class TestAffineScan:
    def test_blocked_matches_scan_real(self):
        from cubicsdr.ops.iir import affine_scan_1st_order
        rng = np.random.default_rng(3)
        d = jnp.asarray(rng.standard_normal((2, 4096)).astype(np.float32))
        y0 = jnp.asarray(rng.standard_normal(2).astype(np.float32))
        fast = affine_scan_1st_order(0.97, d, y0)            # blocked path
        exact = affine_scan_1st_order(0.97, d, y0, tile=1 << 20)  # scan path
        np.testing.assert_allclose(np.asarray(fast), np.asarray(exact),
                                   rtol=0, atol=2e-4)

    def test_complex_coefficient_long_block(self):
        # Regression: long blocks once routed complex c into the
        # float-only blocked form (TypeError); they must fall through to
        # the generic associative scan.
        from cubicsdr.ops.iir import affine_scan_1st_order
        rng = np.random.default_rng(4)
        c = np.complex64(0.95 * np.exp(1j * 0.3))
        d = jnp.asarray((rng.standard_normal(4096)
                         + 1j * rng.standard_normal(4096))
                        .astype(np.complex64))
        y0 = jnp.zeros((), jnp.complex64)
        y = affine_scan_1st_order(c, d, y0)
        ref = np.empty(4096, np.complex64)
        acc = 0.0 + 0.0j
        dn = np.asarray(d)
        for i in range(4096):
            acc = c * acc + dn[i]
            ref[i] = acc
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=2e-3)


class TestDigitalKitCarryDtype:
    def test_carry_matches_construction_dtype(self):
        from cubicsdr.modems.digital import ConstellationKit, GMSKKit
        from cubicsdr.modems.digital import psk_constellation
        from cubicsdr.ops.planar import PC, PLANAR
        pts = psk_constellation(4)
        planar = ConstellationKit(pts, differential=True, batch_shape=(3,),
                                  dtype=PLANAR).shard_carry_init()
        assert isinstance(planar, PC) and planar.re.shape == (3, 1)
        cplx = ConstellationKit(pts, differential=True, batch_shape=(3,),
                                dtype=jnp.complex64).shard_carry_init()
        assert jnp.iscomplexobj(cplx) and cplx.shape == (3, 1)
        g = GMSKKit(4, batch_shape=(2,), dtype=jnp.complex64)
        assert jnp.iscomplexobj(g.shard_carry_init())
