"""Runtime modem-settings editing (ref: src/ModemProperties.cpp:1-299
generated properties panel; schema surface src/modules/modem/Modem.h:
141-146): REST reads the typed ModemArg schema and writes onto a LIVE
demod, rebuilding the compiled plan with state carry — untouched demods'
audio never glitches."""

import numpy as np
import jax.numpy as jnp
import pytest

from cubicsdr.io.sources import SyntheticSource, Station
from cubicsdr.ops.planar import PC, PLANAR
from cubicsdr.receiver import (
    DemodulatorMgr, ReceiverPipeline, plan_from_manager,
    controls_from_manager)

FS = 1_000_000


def _viewer(mgr, keyed, rx, controls, center=100e6):
    from cubicsdr.app.runner import LiveReceiver
    from cubicsdr.app.webview import WebViewer
    lr = LiveReceiver(rx, controls, iter([]), center_freq=center,
                      waterfall_fft=256, waterfall_lines=8)
    return lr, WebViewer(lr, mgr, keyed, port=0)    # never started: direct


def test_settings_schema_and_validation():
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    mgr.new_demodulator(100e6 - 300e3, "FSK", 19200)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, dtype=PLANAR)
    lr, viewer = _viewer(mgr, keyed, rx,
                         controls_from_manager(mgr, rx, keyed, 100e6))

    # Schema surface: FSK exposes bps/sps/bw as typed args with ranges.
    sch = viewer.modem_settings_json(1)
    assert sch["ok"] and sch["type"] == "FSK"
    keys = {a["key"]: a for a in sch["schema"]}
    assert keys["bps"]["type"] == "int" and keys["bps"]["low"] == 1
    assert "sps" in keys and "bw" in keys

    # Validation: unknown key, bad type, out-of-range all rejected.
    assert not viewer.control({"action": "modem_settings", "index": 1,
                               "settings": {"nope": 1}})["ok"]
    assert not viewer.control({"action": "modem_settings", "index": 1,
                               "settings": {"bps": "xyz"}})["ok"]
    assert not viewer.control({"action": "modem_settings", "index": 1,
                               "settings": {"bps": 99}})["ok"]
    assert not viewer.control({"action": "modem_settings", "index": 1,
                               "settings": {}})["ok"]
    # Index bounds on the GET surface.
    assert not viewer.modem_settings_json(7)["ok"]


def test_flip_fsk_bps_and_fms_demph_mid_stream():
    """Acceptance: flip FSK bps and FMS demph on a
    RUNNING receiver; the untouched FM demod's audio continues exactly
    as if no rebuild happened (state carry), and the edited settings are
    live in the new compiled plan."""
    fm = (100e6 + 200e3, "FM", 200000)
    fms = (100e6 - 200e3, "FMS", 200000)
    fsk = (100e6 + 400e3, "FSK", 19200)

    # One block size valid for every plan in this test.
    from cubicsdr.receiver import DemodGroupSpec
    L = ReceiverPipeline(
        FS, [DemodGroupSpec("FM", 200000, 1),
             DemodGroupSpec("FMS", 200000, 1),
             DemodGroupSpec("FSK", 19200, 1)], dtype=PLANAR).block_len

    src = SyntheticSource(FS, L, [Station(200e3, "fm", audio_freq=800.0),
                                  Station(-200e3, "fm", audio_freq=400.0),
                                  Station(400e3, "tone")])
    blocks = [next(src) for _ in range(6)]

    def fm_audio(out, gi):
        return np.asarray(out["groups"][gi]["audio"][0])

    # --- reference: never-rebuilt FM-only pipeline ---
    mgr_a = DemodulatorMgr()
    mgr_a.new_demodulator(*fm)
    specs, keyed_a = plan_from_manager(mgr_a)
    rx_a = ReceiverPipeline(FS, specs, dtype=PLANAR, block_len=L)
    ctl_a = controls_from_manager(mgr_a, rx_a, keyed_a, 100e6)
    st = rx_a.init_state()
    ref = []
    for b in blocks:
        st, out = rx_a.apply(st, (PC(jnp.asarray(b.real),
                                     jnp.asarray(b.imag)), ctl_a))
        ref.append(fm_audio(out, 0))

    # --- live run: FM + FMS + FSK, settings flipped after block 3 ---
    mgr = DemodulatorMgr()
    d_fm = mgr.new_demodulator(*fm)
    mgr.new_demodulator(*fms)
    mgr.new_demodulator(*fsk)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, dtype=PLANAR, block_len=L)
    lr, viewer = _viewer(mgr, keyed, rx,
                         controls_from_manager(mgr, rx, keyed, 100e6))

    def group_of(type_name):
        return next(gi for gi, g in enumerate(lr.pipeline.groups)
                    if g.modem_name == type_name)

    got, fsk_before, fsk_after = [], [], []
    for i, b in enumerate(blocks):
        if i == 3:
            r = viewer.control({"action": "modem_settings", "index": 2,
                                "settings": {"bps": 2}})
            assert r["ok"] and r["settings"]["bps"] == 2
            r = viewer.control({"action": "modem_settings", "index": 1,
                                "settings": {"demph": 50}})
            assert r["ok"] and r["settings"]["demph"] == 50
            assert lr.pipeline.block_len == L       # pinned size survives
            # The edited settings are part of the NEW compiled plan.
            g_fsk = lr.pipeline.groups[group_of("FSK")]
            assert dict(g_fsk.settings)["bps"] == 2
            g_fms = lr.pipeline.groups[group_of("FMS")]
            assert dict(g_fms.settings)["demph"] == 50
        iq = PC(jnp.asarray(b.real), jnp.asarray(b.imag))
        lr.state, out = lr.step(lr.state, (iq, lr.controls))
        got.append(fm_audio(out, group_of("FM")))
        syms = np.asarray(out["groups"][group_of("FSK")]["symbols"][0])
        (fsk_after if i >= 3 else fsk_before).append(syms)

    # Untouched FM demod: audio continuous through BOTH rebuilds
    # (tolerance covers XLA fusion-order float noise between programs).
    for i in (3, 4, 5):
        np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=2e-3)
    # Sanity: the carried state mattered — a cold restart at block 3
    # diverges from the reference.
    st_cold = rx_a.init_state()
    _, out_cold = rx_a.apply(
        st_cold, (PC(jnp.asarray(blocks[3].real),
                     jnp.asarray(blocks[3].imag)), ctl_a))
    assert not np.allclose(fm_audio(out_cold, 0), ref[3], atol=2e-3)
    # bps flip is live: 4-ary symbols appear (bps=2 => symbols in 0..3).
    assert max(s.max() for s in fsk_after) > 1
    assert max(s.max() for s in fsk_before) <= 1
    assert np.isfinite(got[-1]).all()


def test_runtime_per_demod_recording(tmp_path):
    """Acceptance: start recording ONE demod at runtime,
    stream, change options, stop — valid finalized WAV with time-limit
    rotation honored; the other demod never records (ref: src/demod/
    DemodulatorInstance.cpp:600-655 startRecording/stopRecording,
    src/audio/AudioSinkFileThread.cpp:28-73)."""
    import time
    from cubicsdr.io.wav import read_wav

    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    am = mgr.new_demodulator(100e6 - 300e3, "AM", 10000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, dtype=PLANAR)
    lr, viewer = _viewer(mgr, keyed, rx,
                         controls_from_manager(mgr, rx, keyed, 100e6))
    src = SyntheticSource(FS, rx.block_len,
                          [Station(200e3, "fm", audio_freq=800.0),
                           Station(-300e3, "am", audio_freq=500.0)])

    def stream(n):
        for _ in range(n):
            b = next(src)
            lr.ring.write(b.real.astype(np.float32),
                          b.imag.astype(np.float32))
        lr.run_blocks(max_blocks=n, wait=False)

    stream(2)                            # not recording yet
    assert not list(tmp_path.iterdir())

    base = str(tmp_path / "rec")
    assert viewer.control({"action": "record_opts", "path": base,
                           "time_limit": 0.05, "squelch": "always"})["ok"]
    # Start recording the AM demod only (mgr index 1).
    assert viewer.control({"action": "set", "index": 1,
                           "key": "recording", "value": True})["ok"]
    st = viewer.state_json()
    assert [d["recording"] for d in st["demods"]] == [False, True]
    assert st["record"]["time_limit"] == 0.05

    t0 = time.time()
    stream(6)
    while time.time() - t0 < 0.12:       # ensure the rotation clock ticks
        time.sleep(0.01)
    stream(6)

    # Stop -> sink closed, WAV finalized.
    assert viewer.control({"action": "set", "index": 1,
                           "key": "recording", "value": False})["ok"]
    assert not viewer.state_json()["demods"][1]["recording"]
    assert not lr._recorders

    wavs = sorted(tmp_path.iterdir())
    assert len(wavs) >= 2                # base + >=1 rotated file
    total = 0
    for w in wavs:
        data, rate = read_wav(str(w))
        assert rate == rx.audio_rate
        total += data.shape[-1]
    assert total == 12 * rx.audio_len    # every recorded block landed
    # Only the AM demod recorded — files carry its stable instance id
    # (the WAV follows the demod across plan rebuilds).
    assert all(f"demod{am._id}" in w.name for w in wavs)

    # Restart recording appends to a FRESH sink (old file intact).
    assert viewer.control({"action": "set", "index": 1,
                           "key": "recording", "value": True})["ok"]
    stream(2)
    lr.stop()


def test_multi_sink_audio_routing(tmp_path):
    """Acceptance: two host sinks, each fed a DIFFERENT
    demod subset mixed host-side (ref: src/audio/AudioThread.cpp:370-442
    per-device controller mixing). wav backends capture each sink."""
    from cubicsdr.io.wav import read_wav

    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)   # 800 Hz tone
    mgr.new_demodulator(100e6 - 300e3, "AM", 10000)    # 500 Hz tone
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, dtype=PLANAR)
    lr, viewer = _viewer(mgr, keyed, rx,
                         controls_from_manager(mgr, rx, keyed, 100e6))
    src = SyntheticSource(FS, rx.block_len,
                          [Station(200e3, "fm", audio_freq=800.0),
                           Station(-300e3, "am", audio_freq=500.0)])

    wav_a, wav_b = str(tmp_path / "a"), str(tmp_path / "b")
    assert viewer.control({"action": "audio_output", "name": "spkA",
                           "backend": f"wav:{wav_a}",
                           "demods": [0]})["ok"]
    assert viewer.control({"action": "audio_output", "name": "spkB",
                           "backend": f"wav:{wav_b}",
                           "demods": [1]})["ok"]
    assert set(lr.audio_sinks) == {"spkA", "spkB"}

    for _ in range(6):
        b = next(src)
        lr.ring.write(b.real.astype(np.float32),
                      b.imag.astype(np.float32))
    lr.run_blocks(max_blocks=6, wait=False)
    # Detach both sinks (no backend) -> wav files finalized.
    assert viewer.control({"action": "audio_output", "name": "spkA"})["ok"]
    assert viewer.control({"action": "audio_output", "name": "spkB"})["ok"]
    assert not lr.audio_sinks
    lr.stop()

    def tone_of(path):
        d, rate = read_wav(path + ".wav" if not path.endswith(".wav")
                           else path)
        x = d.mean(axis=0) if d.ndim == 2 else d
        x = x[len(x) // 2:]                      # skip warm-up
        X = np.abs(np.fft.rfft(x * np.hanning(len(x))))
        return np.fft.rfftfreq(len(x), 1 / rate)[np.argmax(X)]

    import os
    fa = wav_a + ("" if os.path.exists(wav_a) else ".wav")
    fb = wav_b + ("" if os.path.exists(wav_b) else ".wav")
    assert abs(tone_of(fa) - 800.0) < 20         # sink A: the FM demod
    assert abs(tone_of(fb) - 500.0) < 20         # sink B: the AM demod


def test_recording_rejected_for_digital_demods():
    """Digital demods emit symbols, not audio: toggling recording must be
    a clear error, not a silent always-on recording flag that never
    writes a file (round-4 review finding)."""
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    mgr.new_demodulator(100e6 - 300e3, "BPSK", 20000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, dtype=PLANAR)
    lr, viewer = _viewer(mgr, keyed, rx,
                         controls_from_manager(mgr, rx, keyed, 100e6))
    r = viewer.control({"action": "set", "index": 1, "key": "recording",
                        "value": True, "path": "/tmp/never"})
    assert not r["ok"] and "symbols" in r["error"]
    assert not lr.any_recording()


def test_live_checkpoint_restore_is_bit_continuous(tmp_path):
    """REST checkpoint/restore of the RUNNING receiver: restoring the
    saved streaming state and replaying the same block reproduces the
    post-checkpoint audio exactly (the reference's session restore loses
    filter state; ref SURVEY §5 checkpoint/resume deliverable)."""
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, dtype=PLANAR)
    lr, viewer = _viewer(mgr, keyed, rx,
                         controls_from_manager(mgr, rx, keyed, 100e6))
    src = SyntheticSource(FS, rx.block_len,
                          [Station(200e3, "fm", audio_freq=800.0)])
    blocks = [next(src) for _ in range(4)]
    audio = []
    lr.on_block = lambda o: audio.append(o["mix"].copy())

    def stream(blks):
        for b in blks:
            lr.ring.write(b.real.astype(np.float32),
                          b.imag.astype(np.float32))
        lr.run_blocks(max_blocks=len(blks), wait=False)

    stream(blocks[:3])
    p = str(tmp_path / "ckpt.json")
    res = viewer.session_io({"op": "checkpoint", "path": p})
    assert res["ok"]
    stream(blocks[3:])                    # keep going past the checkpoint
    a3 = audio[3]

    # ... later/elsewhere: restore and replay block 3.
    audio.clear()
    res = viewer.session_io({"op": "restore", "path": p})
    assert res["ok"], res
    stream(blocks[3:])
    np.testing.assert_allclose(audio[0], a3, rtol=0, atol=1e-6)
