"""Channelizer correctness: tone routing, unity gain, isolation, streaming
equivalence, oversampled output rate (SURVEY.md §4 item 1-2; reference
behavior: src/sdr/SDRPostThread.cpp:406-511)."""

import numpy as np
import jax.numpy as jnp
import pytest

from cubicsdr.ops.channelizer import (
    ChannelizerPFB, ChannelizerPFB2, channel_centers)
from tests.conftest import make_tone


@pytest.mark.parametrize("M", [4, 16])
def test_pfbch_tone_routing(M):
    fs = M * 100e3
    ch = ChannelizerPFB(M)
    centers = channel_centers(M, fs)
    for k in [0, 1, M // 2, M - 1]:
        x = make_tone(M * 2048, centers[k], fs)
        st = ch.init_state()
        st, y = ch.apply(st, jnp.asarray(x))
        y = np.asarray(y)[:, 256:]
        pw = (np.abs(y) ** 2).mean(axis=1)
        assert pw.argmax() == k
        # Unity passband gain, >=60 dB neighbor isolation.
        assert abs(np.sqrt(pw[k]) - 1.0) < 0.01
        others = np.delete(pw, k)
        assert 10 * np.log10(others.max() / pw[k]) < -60


def test_pfbch_offset_tone_lands_at_offset():
    """A tone offset from a channel center appears at that offset in the
    channel's (fs/M-rate) output."""
    M, fs = 8, 800e3
    ch = ChannelizerPFB(M)
    off = 12e3
    centers = channel_centers(M, fs)
    x = make_tone(M * 4096, centers[3] + off, fs)
    st, y = ch.apply(ch.init_state(), jnp.asarray(x))
    y = np.asarray(y)[3, 1024:]
    spec = np.abs(np.fft.fft(y * np.hanning(len(y))))
    fpk = np.fft.fftfreq(len(y), M / fs)[spec.argmax()]
    assert abs(fpk - off) < (fs / M) / len(y) * 2


def test_pfbch_streaming_equals_oneshot():
    M, fs = 8, 800e3
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(M * 1024) + 1j * rng.standard_normal(M * 1024)
         ).astype(np.complex64)
    ch = ChannelizerPFB(M)
    st, y_full = ch.apply(ch.init_state(), jnp.asarray(x))
    st = ch.init_state()
    outs = []
    for blk in x.reshape(4, -1):
        st, y = ch.apply(st, jnp.asarray(blk))
        outs.append(np.asarray(y))
    y_stream = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(y_stream, np.asarray(y_full), atol=1e-4)


def test_pfbch2_tone_routing_and_rate():
    M, fs = 16, 1.6e6
    ch2 = ChannelizerPFB2(M)
    centers = channel_centers(M, fs)
    x = make_tone(M * 2048, centers[5] + 20e3, fs)
    st, y = ch2.apply(ch2.init_state(), jnp.asarray(x))
    y = np.asarray(y)
    # 2x oversampled: L inputs -> 2L/M per channel.
    assert y.shape == (M, 2 * (M * 2048) // M)
    pw = (np.abs(y[:, 1024:]) ** 2).mean(axis=1)
    assert pw.argmax() == 5
    # Offset tone appears at +20 kHz in the 2*fs/M = 200 kS/s channel.
    yk = y[5, 1024:]
    spec = np.abs(np.fft.fft(yk * np.hanning(len(yk))))
    fpk = np.fft.fftfreq(len(yk), M / (2 * fs))[spec.argmax()]
    assert abs(fpk - 20e3) < (2 * fs / M) / len(yk) * 2


def test_pfbch2_streaming_equals_oneshot():
    M = 8
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(M * 512) + 1j * rng.standard_normal(M * 512)
         ).astype(np.complex64)
    ch = ChannelizerPFB2(M)
    st, y_full = ch.apply(ch.init_state(), jnp.asarray(x))
    st = ch.init_state()
    outs = []
    for blk in x.reshape(8, -1):
        st, y = ch.apply(st, jnp.asarray(blk))
        outs.append(np.asarray(y))
    y_stream = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(y_stream, np.asarray(y_full), atol=1e-4)


def test_channel_centers_wrap():
    c = channel_centers(8, 800e3)
    assert c[0] == 0
    assert c[1] == 100e3
    assert c[4] == 400e3          # fs/2 stays positive
    assert c[5] == -300e3         # wrapped
    assert c[7] == -100e3
