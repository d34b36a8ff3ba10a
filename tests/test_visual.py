"""Visual pipeline: spectrum math, distributor pacing, scope, waterfall,
view zoom (ref behavior: src/process/**)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cubicsdr.visual import (
    SpectrumProcessor, FFTDataDistributor, ScopeProcessor, Waterfall,
    Gradient, THEMES)
from cubicsdr.visual.spectrum import SpectrumView, SPECTRUM_VZM
from tests.conftest import make_tone


def test_spectrum_tone_peak_location():
    fft_size = 512
    sp = SpectrumProcessor(fft_size)
    fs = 1e6
    f0 = 125e3                     # -> bin fft_size/2 + fft_size/8
    n = sp.n
    x = make_tone(n * 20, f0, fs).reshape(20, n)
    st, out = sp.apply(sp.init_state(), jnp.asarray(x))
    pts = np.asarray(out["spectrum_points"])
    assert pts.shape == (fft_size,)
    expected_bin = fft_size // 2 + int(f0 / fs * fft_size)
    assert abs(int(pts.argmax()) - expected_bin) <= 1
    # Normalized: peak near 1, floor near 0.
    assert 0.7 < pts.max() <= 1.2
    assert np.median(pts) < 0.4


def test_spectrum_ema_converges():
    sp = SpectrumProcessor(256, fft_average_rate=0.65)
    x = make_tone(sp.n * 50, 10e3, 1e6).reshape(50, sp.n)
    st = sp.init_state()
    st, out1 = sp.apply(st, jnp.asarray(x[:25]))
    st, out2 = sp.apply(st, jnp.asarray(x[25:]))
    # Steady state: ceiling stops moving.
    assert abs(float(out2["fft_ceiling"]) - float(out1["fft_ceiling"])) < \
        0.1 * abs(float(out2["fft_ceiling"]))


def test_spectrum_peak_hold():
    sp = SpectrumProcessor(256, peak_hold=True)
    burst = make_tone(sp.n * 10, 50e3, 1e6).reshape(10, sp.n) * 2.0
    quiet = burst * 0.01
    st = sp.init_state()
    st, _ = sp.apply(st, jnp.asarray(burst))
    st, out = sp.apply(st, jnp.asarray(quiet))
    pts = np.asarray(out["spectrum_points"])
    hold = np.asarray(out["spectrum_hold_points"])
    assert hold.max() >= pts.max() - 1e-3


def test_distributor_paces_lines():
    fs, fft = 480e3, 1024
    L = 48000                        # 0.1 s blocks
    dist = FFTDataDistributor(fft, fs, lines_per_second=30, block_len=L)
    st = dist.init_state()
    total_valid = 0
    for i in range(10):              # 1 second total
        x = make_tone(L, 10e3, fs, phase=i)
        st, (frames, valid) = dist.apply(st, jnp.asarray(x))
        assert frames.shape[-1] == fft
        total_valid += int(np.asarray(valid).sum())
    assert abs(total_valid - 30) <= 2


def test_distributor_high_lps_overlap():
    fs, fft = 100e3, 2048
    L = 10000
    dist = FFTDataDistributor(fft, fs, lines_per_second=100, block_len=L)
    st = dist.init_state()
    n = 0
    for i in range(5):
        st, (frames, valid) = dist.apply(
            st, jnp.asarray(make_tone(L, 1e3, fs, phase=i)))
        n += int(np.asarray(valid).sum())
    assert abs(n - 50) <= 2          # 0.5 s at 100 lps


def test_spectrum_view_zoom():
    fs, fft_size = 1e6, 256
    view_bw = 125e3
    view_off = 200e3
    sv = SpectrumView(fs, view_off, view_bw, fft_size)
    sp = SpectrumProcessor(fft_size)
    # Tone 10 kHz above the view center must appear right of center.
    x = make_tone(1 << 17, view_off + 10e3, fs)
    st_v, st_s = sv.init_state(), sp.init_state()
    st_v, frames = sv.apply(st_v, jnp.asarray(x))
    assert frames.shape[0] >= 1
    st_s, out = sp.apply(st_s, frames)
    pts = np.asarray(out["spectrum_points"])
    peak_bin = int(pts.argmax())
    expect = fft_size // 2 + int(10e3 / sv.resample_bw * fft_size)
    assert abs(peak_bin - expect) <= 2


def test_scope_modes_and_audio_fft():
    from cubicsdr.visual.scope import scope_trace
    audio = jnp.stack([jnp.sin(jnp.arange(1000) * 0.1),
                       jnp.cos(jnp.arange(1000) * 0.1)])
    assert scope_trace(audio, "Y").shape == (1, 1000)
    assert scope_trace(audio, "2Y").shape == (2, 1000)
    assert scope_trace(audio, "XY").shape == (2, 1000)
    sc = ScopeProcessor(fft_size=128)
    t = np.arange(sc.n * 4) / 48000
    a = np.sin(2 * np.pi * 3000 * t, dtype=np.float64).astype(np.float32)
    st, out = sc.apply(sc.init_state(), jnp.asarray(a[None, :]))
    pts = np.asarray(out["spectrum_points"])
    # Real audio -> symmetric +-3 kHz peaks at bins 64 -/+ 8.
    assert int(pts.argmax()) in (55, 56, 57, 71, 72, 73)
    assert pts[56] > 0.7 and pts[72] > 0.7


def test_waterfall_roll_and_render(tmp_path):
    wf = Waterfall(64, lines=16, theme="jet")
    wf.add_lines(np.linspace(0, 1, 64))
    wf.add_lines(np.tile(np.linspace(0, 1, 64), (3, 1)))
    rgb = wf.render_rgb()
    assert rgb.shape == (16, 64, 3)
    assert rgb.min() >= 0 and rgb.max() <= 1
    p = str(tmp_path / "wf.png")
    wf.render_png(p)
    assert os.path.getsize(p) > 100
    for name in ["default", "jet", "bw", "sharp", "rad", "touch", "hd",
                 "radar"]:
        assert name in THEMES


def test_gradient_interpolation():
    g = Gradient([(0.0, (0, 0, 0)), (1.0, (1, 0.5, 0))])
    pal = g.generate(11)
    np.testing.assert_allclose(pal[5], [0.5, 0.25, 0], atol=1e-6)
