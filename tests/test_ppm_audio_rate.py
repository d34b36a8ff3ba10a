"""Round-5 micro-parity: per-sink audio sample rate (host resampling) and
the PPM calibration aid (ref: src/audio/AudioThread.cpp:493-506 per-device
negotiated rate; src/visual/ScopeCanvas.h:35-36 PPM mode + AppFrame.cpp:
1996-2005 frequency-correction setting)."""

import json
import threading
import urllib.request
import wave

import numpy as np
import pytest

from cubicsdr.io.audio_out import HostResampler
from cubicsdr.io.sources import SyntheticSource, Station
from cubicsdr.ops.planar import PLANAR
from cubicsdr.receiver import (
    DemodulatorMgr, ReceiverPipeline, plan_from_manager,
    controls_from_manager)

FS = 1_000_000


def _tone_freq(x, rate):
    X = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    f = np.fft.rfftfreq(len(x), 1.0 / rate)
    return float(f[np.argmax(X * (f > 50.0))])


def test_host_resampler_tone_and_streaming_equivalence():
    rs = HostResampler(48000, 44100)
    n = 48000
    t = np.arange(n) / 48000.0
    x = np.stack([np.sin(2 * np.pi * 1000.0 * t),
                  np.sin(2 * np.pi * 2500.0 * t)]).astype(np.float32)
    one = rs.process(x)
    assert abs(one.shape[1] - n * 44100 / 48000) < 64
    assert abs(_tone_freq(one[0], 44100) - 1000.0) < 5
    assert abs(_tone_freq(one[1], 44100) - 2500.0) < 5
    # amplitude preserved through the polyphase gain
    assert abs(np.abs(one[0][2000:-2000]).max() - 1.0) < 0.02

    # streaming in odd chunks == one-shot, bit-exact
    rs2 = HostResampler(48000, 44100)
    parts, i = [], 0
    for step in (37, 1000, 4096, 12345):
        while i < n:
            parts.append(rs2.process(x[:, i:i + step]))
            i += step
            if len(parts) > 3 and step == 37:
                break
    chunks = np.concatenate([p for p in parts if p.size], axis=1)
    m = min(chunks.shape[1], one.shape[1])
    np.testing.assert_allclose(chunks[:, :m], one[:, :m], atol=1e-6)


def test_host_resampler_upsample():
    rs = HostResampler(44100, 48000)
    t = np.arange(44100) / 44100.0
    y = rs.process(np.sin(2 * np.pi * 997.0 * t)[None, :].astype(
        np.float32))
    assert abs(_tone_freq(y[0], 48000) - 997.0) < 5


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=20) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=20) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def hx():
    from cubicsdr.app.runner import LiveReceiver
    from cubicsdr.app.webview import WebViewer

    class H:
        def __init__(self):
            self.mgr = DemodulatorMgr()
            self.mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
            specs, keyed = plan_from_manager(self.mgr)
            rx = ReceiverPipeline(FS, specs, dtype=PLANAR)
            controls = controls_from_manager(self.mgr, rx, keyed, 100e6)
            self.done = threading.Event()
            h = self

            class _Src:
                def __iter__(self):
                    # The -300 kHz unmodulated carrier is the PPM
                    # calibration reference (FM spectra peak at the
                    # deviation edges, useless for carrier measurement).
                    src = SyntheticSource(
                        FS, h.lr.pipeline.block_len,
                        [Station(200e3, "fm", audio_freq=800.0),
                         Station(-300e3, "tone")])
                    while not h.done.is_set():
                        yield next(src)

            self.lr = LiveReceiver(rx, controls, _Src(),
                                   center_freq=100e6, waterfall_fft=256,
                                   waterfall_lines=16)
            self.viewer = WebViewer(self.lr, self.mgr, keyed,
                                    port=0).start()
            self.port = self.viewer.port
            self.lr.start_producer()
            self.lr.run_blocks(max_blocks=3)

        def stop(self):
            self.done.set()
            self.lr.stop()
            self.viewer.stop()

    h = H()
    yield h
    h.stop()


def test_sink_with_own_sample_rate(hx, tmp_path):
    """A 44.1 kHz sink against the 48 kHz pipeline: host-resampled WAV
    at the sink's own rate with the demod tone intact."""
    wav_path = str(tmp_path / "rate44.wav")
    assert _post(hx.port, "/api/control",
                 {"action": "audio_output", "name": "spk44",
                  "backend": f"wav:{wav_path}", "rate": 44100})["ok"]
    ad = _get(hx.port, "/api/audio_devices")
    assert ad["sinks"]["spk44"]["rate"] == 44100
    hx.lr.run_blocks(max_blocks=6)
    assert _post(hx.port, "/api/control",
                 {"action": "audio_output", "name": "spk44",
                  "backend": None})["ok"]
    with wave.open(wav_path) as w:
        assert w.getframerate() == 44100
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    audio = pcm.reshape(-1, 2).mean(axis=1) / 32767.0
    assert audio.size > 3000
    assert abs(_tone_freq(audio, 44100) - 800.0) < 10


def test_ppm_set_and_measure(hx):
    # Set/nudge the device correction (persisted in DeviceConfig).
    assert _post(hx.port, "/api/control",
                 {"action": "ppm", "value": -12})["ppm"] == -12
    assert _post(hx.port, "/api/control",
                 {"action": "ppm", "delta": 2})["ppm"] == -10
    # Measure: the synthetic carrier sits at center-300 kHz; claiming it
    # SHOULD be at center-310 kHz must report a ~+10 kHz offset (~+100
    # ppm at ~100 MHz) and suggest current-offset.
    hx.lr.run_blocks(max_blocks=2)
    m = _get(hx.port, "/api/ppm?ref=99690000")
    assert m["ok"], m
    assert abs(m["offset_hz"] - 10e3) < 2.5e3       # ±half a bin
    assert abs(m["offset_ppm"] - m["offset_hz"] / 99.69e6 * 1e6) < 0.1
    assert abs(m["suggested_ppm"] - (-10 - m["offset_ppm"])) < 0.01
    # Out-of-span reference errors cleanly.
    assert not _get(hx.port, "/api/ppm?ref=999000000")["ok"]
