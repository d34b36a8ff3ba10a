"""Control-plane churn vs the live loop (CPU-shortened soak).

The donated-state + lookahead-dispatch design makes every control/consumer
race a potential use-after-free of device buffers, and the round-4 fixes
(lookahead locking, dispatch-time key/control snapshots) were found only
by self-review — this test makes a second thread hammer the REST control
surface (add/remove demods, retunes, modem swaps, bandwidth edits,
recording toggles, zoom, checkpoint/restore, audio routing, display)
while `run_blocks` streams continuously, asserting:

  * the consumer thread never dies (no exception escapes run_blocks),
  * the ring sheds nothing (back-pressure source => 0 ingest drops),
  * a surviving FM demod's tone stays present across EVERY plan rebuild
    (audio keyed to its stable instance id via a subset sink), the
    reference's retune-never-glitches contract
    (ref: src/demod/DemodulatorPreThread.cpp:105-151).
"""

import json
import threading
import time
import urllib.request
import wave

import numpy as np

from cubicsdr.io.sources import SyntheticSource, Station
from cubicsdr.ops.planar import PLANAR
from cubicsdr.receiver import (
    DemodulatorMgr, ReceiverPipeline, plan_from_manager,
    controls_from_manager)

FS = 1_000_000
TONE = 800.0


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _ctl(port, body):
    return _post(port, "/api/control", body)


def test_churn_adversary_vs_live_loop(tmp_path):
    from cubicsdr.app.runner import LiveReceiver
    from cubicsdr.app.webview import WebViewer

    mgr = DemodulatorMgr()
    survivor = mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, dtype=PLANAR)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)

    stop = threading.Event()

    class _Src:
        """Back-pressure source: waits for ring space instead of
        shedding, so ingest drops stay a real health signal."""

        def __init__(self):
            self.get_ring = lambda: None     # late-bound: format swaps
            self.n = 8192                    # replace the receiver's ring

        def __iter__(self):
            src = SyntheticSource(FS, self.n,
                                  [Station(200e3, "fm", audio_freq=TONE)])
            while not stop.is_set():
                ring = self.get_ring()
                while (ring is not None
                       and ring.fill + self.n > ring.capacity
                       and not stop.is_set()):
                    time.sleep(0.0005)
                    ring = self.get_ring()
                yield next(src)

        def stop(self):
            stop.set()

    src = _Src()
    lr = LiveReceiver(rx, controls, src, center_freq=100e6,
                      waterfall_fft=256, waterfall_lines=16)
    src.get_ring = lambda: lr.ring
    viewer = WebViewer(lr, mgr, keyed, port=0).start()
    port = viewer.port
    lr.start_producer()

    consumer_exc = []

    def consume():
        try:
            lr.run_blocks()
        except Exception as e:               # noqa: BLE001 — the assert
            consumer_exc.append(e)

    th = threading.Thread(target=consume, daemon=True)
    th.start()

    blocks_at = lambda: lr.metrics.snapshot().get(  # noqa: E731
        "pipeline", {}).get("blocks", 0)

    def wait_blocks(n, timeout=60.0):
        t0, base = time.time(), blocks_at()
        while blocks_at() < base + n and time.time() - t0 < timeout:
            time.sleep(0.01)
            assert not consumer_exc, consumer_exc

    try:
        wait_blocks(3)

        # --- phase A: checkpoint/restore + structural churn ------------
        ck = str(tmp_path / "churn_ck.json")
        assert _post(port, "/api/session",
                     {"op": "checkpoint", "path": ck})["ok"]
        assert _ctl(port, {"action": "add", "freq": 100e6 - 300e3,
                           "type": "AM", "bandwidth": 10000})["ok"]
        wait_blocks(2)
        assert _post(port, "/api/session",
                     {"op": "restore", "path": ck})["ok"]
        wait_blocks(2)
        assert not consumer_exc, consumer_exc

        # Restore re-created the instances: rebind the survivor handle.
        survivor = mgr.get_demodulators()[0]
        assert survivor.demod_type == "FM"

        # --- phase B: the adversary, with audio keyed to the survivor --
        wav_path = str(tmp_path / "survivor.wav")
        assert _ctl(port, {"action": "audio_output", "name": "surv",
                           "backend": f"wav:{wav_path}",
                           "demods": [0]})["ok"]
        churn_demod = None
        for it in range(3):
            # Structural churn: add + modem-swap + bandwidth + remove.
            assert _ctl(port, {"action": "add",
                               "freq": 100e6 - 300e3,
                               "type": ("FM", "AM", "BPSK")[it],
                               "bandwidth": (200000, 10000, 20000)[it]}
                        )["ok"]
            idx = len(mgr.get_demodulators()) - 1
            wait_blocks(2)
            if it == 0:
                assert _ctl(port, {"action": "set", "index": idx,
                                   "key": "type", "value": "NBFM"})["ok"]
                wait_blocks(1)
            if it == 1:
                assert _ctl(port, {"action": "set", "index": idx,
                                   "key": "bandwidth",
                                   "value": 12500})["ok"]
                wait_blocks(1)
            # Control-only churn (no rebuild): retune, squelch, gain.
            assert _ctl(port, {"action": "set", "index": 0,
                               "key": "frequency",
                               "value": 100e6 + 200e3 + it})["ok"]
            assert _ctl(port, {"action": "set", "index": idx,
                               "key": "gain", "value": 0.5})["ok"]
            # Recording toggle on the churn demod (retraces the post
            # step) unless digital.
            if it != 2:
                assert _ctl(port, {"action": "set", "index": idx,
                                   "key": "recording", "value": True,
                                   "path": str(tmp_path / "rec")})["ok"]
                wait_blocks(1)
                assert _ctl(port, {"action": "set", "index": idx,
                                   "key": "recording",
                                   "value": False})["ok"]
            # Display/zoom/solo/view churn (+ the round-5 surfaces:
            # device ppm nudge, bookmark filing/reorder, per-sink rate).
            assert _ctl(port, {"action": "zoom", "offset": 200e3,
                               "bandwidth": 250e3})["ok"]
            assert _ctl(port, {"action": "display",
                               "lps": 20.0 + it})["ok"]
            assert _ctl(port, {"action": "ppm", "delta": 1})["ok"]
            assert _post(port, "/api/bookmarks",
                         {"op": "add", "index": 0, "group": "churn"})["ok"]
            assert _ctl(port, {"action": "audio_output",
                               "name": "chsink",
                               "backend": "null",
                               "rate": 44100,
                               "demods": [0]})["ok"]
            assert _ctl(port, {"action": "audio_solo", "index": 0})["ok"]
            assert _ctl(port, {"action": "view", "index": 0})["ok"]
            wait_blocks(2)
            assert _ctl(port, {"action": "audio_solo",
                               "index": None})["ok"]
            assert _ctl(port, {"action": "view", "index": None})["ok"]
            assert _ctl(port, {"action": "zoom", "offset": None})["ok"]
            # Remove the churn demod; the survivor must ride through.
            assert _ctl(port, {"action": "remove", "index": idx})["ok"]
            wait_blocks(2)
            assert not consumer_exc, consumer_exc

        wait_blocks(4)
    finally:
        stop.set()
        lr._stop.set()
        th.join(timeout=20)
        lr.stop()
        viewer.stop()

    assert not consumer_exc, consumer_exc
    assert not th.is_alive(), "consumer thread hung"

    snap = lr.metrics.snapshot()
    assert int(snap.get("ingest", {}).get("dropped", 0)) == 0

    # Survivor tone continuity: the id-keyed subset sink recorded across
    # every rebuild; nearly all windows must contain the FM tone.
    with wave.open(wav_path) as w:
        rate = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    audio = pcm.reshape(-1, 2).mean(axis=1) / 32767.0
    assert audio.size > rate // 2, "sink recorded almost nothing"
    win = rate // 4                          # 250 ms windows
    n_win = audio.size // win
    good = 0
    for i in range(n_win):
        a = audio[i * win:(i + 1) * win]
        X = np.abs(np.fft.rfft(a * np.hanning(win)))
        f = np.fft.rfftfreq(win, 1.0 / rate)
        k = int(np.argmax(X * (f > 100.0)))
        good += abs(f[k] - TONE) < 40.0
    assert n_win >= 4
    assert good >= n_win - 1, (good, n_win)
