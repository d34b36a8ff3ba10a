"""Zoomed-spectrum view continuity (ref: src/process/
SpectrumVisualProcessor.cpp:304-336 retune bin-shift, :454-492 zoom
rescale): a mid-stream view change must PAN/RESCALE the smoothed display,
never reset it."""

import numpy as np
import jax.numpy as jnp
import pytest

from cubicsdr.ops.planar import PLANAR
from cubicsdr.visual.spectrum import (
    ZoomSpectrumView, shift_display_state, rescale_display_state)


def test_shift_display_state_semantics():
    n = 16
    st = {"ma": jnp.arange(n, dtype=jnp.float32),
          "maa": jnp.arange(n, dtype=jnp.float32) + 100}
    out = shift_display_state(st, 3)
    ma = np.asarray(out["ma"])
    # left shift; vacated tail keeps stale values (memmove, no memset).
    np.testing.assert_array_equal(ma[: n - 3], np.arange(3, n))
    np.testing.assert_array_equal(ma[n - 3:], [13, 14, 15])
    out = shift_display_state(st, -2)
    ma = np.asarray(out["ma"])
    np.testing.assert_array_equal(ma[2:], np.arange(n - 2))
    np.testing.assert_array_equal(ma[:2], [0, 1])


def test_rescale_display_state_semantics():
    n = 16
    st = {"ma": jnp.arange(n, dtype=jnp.float32),
          "maa": jnp.zeros(n, jnp.float32)}
    zin = np.asarray(rescale_display_state(st, zoom_in=True)["ma"])
    np.testing.assert_array_equal(
        zin, [n // 4 + i // 2 for i in range(n)])
    zout = np.asarray(rescale_display_state(st, zoom_in=False)["ma"])
    assert (zout[: n // 4] == 0).all() and (zout[-n // 4:] == 0).all()
    np.testing.assert_array_equal(
        zout[n // 4: n - n // 4], [(i - n // 4) * 2
                                   for i in range(n // 4, n - n // 4)])


def _tone_planes(fs, f, n, amp=1.0):
    t = np.arange(n) / fs
    return np.stack([amp * np.cos(2 * np.pi * f * t),
                     amp * np.sin(2 * np.pi * f * t)]).astype(np.float32)


@pytest.mark.parametrize("dtype", [jnp.complex64, PLANAR])
def test_retune_pans_not_resets(dtype):
    fs = 1_000_000
    L = 1 << 16
    zv = ZoomSpectrumView(fs, L, fft_size=256, dtype=dtype)
    zv.set_view(0.0, 250_000)               # resample_bw = 250 kHz
    assert zv.resample_bw == 250_000
    planes = _tone_planes(fs, 50_000, 8 * L)
    for b in range(8):
        pts = zv.feed(planes[:, b * L: (b + 1) * L])
    assert pts is not None
    peak_before = int(np.argmax(pts))
    ma_before = np.asarray(zv.st_core["ma"]).copy()
    assert ma_before.max() > 0

    # Retune the view up by 1/4 of the span: the tone (fixed in absolute
    # frequency) must appear shifted LEFT by n/4 bins immediately, with the
    # smoothed history carried over — not a blank re-converging display.
    zv.set_view(62_500, 250_000)
    k = int(np.floor(62_500 / (zv.resample_bw / zv.n)))
    ma_after = np.asarray(zv.st_core["ma"])
    np.testing.assert_allclose(ma_after[: zv.n - k], ma_before[k:],
                               rtol=1e-6)
    # And the next display line peaks ~n/4 bins lower (display = fft_size
    # points accumulated from n internal bins).
    for b in range(2):
        pts2 = zv.feed(planes[:, b * L: (b + 1) * L])
    peak_after = int(np.argmax(pts2))
    expected = peak_before - (zv.core.fft_size // 4)
    assert abs(peak_after - expected) <= 2, (peak_before, peak_after)


def test_zoom_rescales_history():
    fs = 1_000_000
    L = 1 << 16
    zv = ZoomSpectrumView(fs, L, fft_size=256, dtype=PLANAR)
    zv.set_view(0.0, 250_000)
    planes = _tone_planes(fs, 31_250, 8 * L)   # +1/8 of the 250k span
    for b in range(8):
        pts = zv.feed(planes[:, b * L: (b + 1) * L])
    peak_before = int(np.argmax(pts))
    ma_before = np.asarray(zv.st_core["ma"]).copy()

    # Zoom IN 2x: old middle half expands to the full display.
    zv.set_view(0.0, 125_000)
    assert zv.resample_bw == 125_000
    ma_after = np.asarray(zv.st_core["ma"])
    n = zv.n
    np.testing.assert_allclose(
        ma_after, ma_before[n // 4 + np.arange(n) // 2], rtol=1e-6)
    # Peak stays put relative to the display center, at twice the offset.
    fft = zv.core.fft_size
    off_before = peak_before - fft // 2
    for b in range(8):
        pts2 = zv.feed(planes[:, b * L: (b + 1) * L])
    off_after = int(np.argmax(pts2)) - fft // 2
    assert abs(off_after - 2 * off_before) <= 2, (off_before, off_after)


def test_runner_zoom_wiring():
    """LiveReceiver.set_zoom feeds the zoom view from the live stream and
    the webview surfaces its points."""
    from cubicsdr.app.runner import LiveReceiver
    from cubicsdr.io.sources import SyntheticSource, Station
    from cubicsdr.receiver import (
        DemodulatorMgr, ReceiverPipeline, plan_from_manager,
        controls_from_manager)

    fs = 1_000_000
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(fs, specs, dtype=PLANAR)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)

    class _Src:
        def __iter__(self):
            src = SyntheticSource(fs, rx.block_len,
                                  [Station(200e3, "tone")])
            for _ in range(10):
                yield next(src)

    lr = LiveReceiver(rx, controls, _Src(), waterfall_fft=256,
                      waterfall_lines=16)
    lr.set_zoom(200e3, 250_000)
    lr.start_producer()
    lr.run_blocks()
    lr.stop()
    assert lr.zoom is not None and lr.zoom.points is not None
    pts = np.asarray(lr.zoom.points)
    assert pts.shape == (256,) and np.isfinite(pts).all()
    # The FM station sits at the view center -> peak near the middle.
    assert abs(int(np.argmax(pts)) - 128) < 24


def test_zoom_program_cache_reuse():
    """Zooming in then back out must reuse the cached jitted program for
    each revisited (P, Q, chunk) — a view compile stalls the stream, so
    repeated zoom levels can never re-jit."""
    fs, L = 1_000_000, 20000
    v = ZoomSpectrumView(fs, L, fft_size=128, dtype=PLANAR)
    step_full = v._step
    v.set_view(0.0, fs / 2)          # zoom in one step
    step_half = v._step
    assert step_half is not step_full
    v.set_view(0.0, fs)              # back out: must be a cache hit
    assert v._step is step_full
    v.set_view(0.0, fs / 2)          # in again: cache hit too
    assert v._step is step_half
    assert v.front_cache_hits >= 2
    # The cached program still runs after reuse.
    rng = np.random.default_rng(0)
    planes = rng.standard_normal((2, L)).astype(np.float32)
    for _ in range(3):
        v.feed(planes)
    assert v.points is not None


def test_prewarm_adjacent_populates_cache():
    fs, L = 1_000_000, 20000
    v = ZoomSpectrumView(fs, L, fft_size=128, dtype=PLANAR)
    assert len(v._front_cache) == 1
    v.prewarm_adjacent(background=False)
    # Full-band view has one neighbor below (fs/2); nothing above.
    assert len(v._front_cache) == 2
    v.set_view(0.0, fs / 2)          # pre-warmed: no new compile object
    assert v.front_cache_hits >= 1
