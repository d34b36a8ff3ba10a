"""Receiver pipeline end-to-end: channelize -> route -> demod farm -> mix,
plus manager semantics and squelch behavior (the reference's streaming hot
path, SURVEY.md §3.2, as one compiled step)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cubicsdr.io.sources import SyntheticSource, Station
from cubicsdr.receiver import (
    DemodulatorMgr, ReceiverPipeline, DemodGroupSpec,
    plan_from_manager, controls_from_manager)


def tone_snr(audio, f0, fs):
    a = audio - audio.mean()
    w = np.hanning(len(a))
    spec = np.abs(np.fft.rfft(a * w)) ** 2
    freqs = np.fft.rfftfreq(len(a), 1 / fs)
    sig = (freqs > f0 - 40) & (freqs < f0 + 40)
    noise = ~sig & (freqs > 50) & (freqs < 15000)
    return 10 * np.log10(spec[sig].sum() / max(spec[noise].sum(), 1e-30))


FS = 2_000_000


def build_rx(n_fm=2, chan_mode="pfbch2"):
    mgr = DemodulatorMgr()
    # Two FM stations inside a 2 MS/s capture.
    freqs = [300e3, -450e3, 610e3][:n_fm]
    for f in freqs:
        d = mgr.new_demodulator(100e6 + f, "FM", 200000)
        d.active = True
    (specs, keyed) = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs, chan_mode=chan_mode)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)
    return mgr, rx, controls, freqs


@pytest.mark.parametrize("chan_mode", ["pfbch2", "pfbch"])
def test_fm_farm_recovers_both_stations(chan_mode):
    mgr, rx, controls, freqs = build_rx(2, chan_mode)
    stations = [Station(freqs[0], "fm", audio_freq=1000.0, deviation=75e3),
                Station(freqs[1], "fm", audio_freq=2000.0, deviation=75e3)]
    src = SyntheticSource(FS, rx.block_len, stations, noise=1e-4)

    step = jax.jit(rx.apply)
    state = rx.init_state()
    outs = []
    n_blocks = int(0.6 * FS / rx.block_len)
    for _ in range(n_blocks):
        state, out = step(state, (jnp.asarray(next(src)), controls))
        outs.append(out)
    audio = np.concatenate(
        [np.asarray(o["groups"][0]["audio"]) for o in outs], axis=-1)
    skip = 9600
    snr0 = tone_snr(audio[0, 0, skip:], 1000.0, 48000)
    snr1 = tone_snr(audio[1, 0, skip:], 2000.0, 48000)
    assert snr0 > 30, f"station 0 SNR {snr0:.1f}"
    assert snr1 > 30, f"station 1 SNR {snr1:.1f}"
    # Mix present and bounded.
    mix = np.concatenate([np.asarray(o["mix"]) for o in outs], axis=-1)
    assert mix.shape[0] == 2
    assert np.abs(mix).max() <= 1.0 + 1e-3


def test_retune_without_recompile():
    mgr, rx, controls, freqs = build_rx(1)
    src = SyntheticSource(FS, rx.block_len,
                          [Station(-450e3, "fm", audio_freq=1500.0)])
    step = jax.jit(rx.apply)
    state = rx.init_state()
    # Start tuned to the wrong place, then retune (same compiled fn).
    controls[0]["frequency"] = np.asarray([300e3], np.float32)
    state, _ = step(state, (jnp.asarray(next(src)), controls))
    n_before = step._cache_size()
    controls[0]["frequency"] = np.asarray([-450e3], np.float32)
    outs = []
    for _ in range(30):
        state, o = step(state, (jnp.asarray(next(src)), controls))
        outs.append(np.asarray(o["groups"][0]["audio"][0, 0]))
    assert step._cache_size() == n_before        # no recompile on retune
    audio = np.concatenate(outs)[9600:]
    assert tone_snr(audio, 1500.0, 48000) > 30


def test_squelch_gates_silence():
    mgr = DemodulatorMgr()
    d = mgr.new_demodulator(100e6 + 300e3, "FM", 200000)
    d.squelch_enabled = True
    d.squelch_level = -20.0       # strong threshold
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)
    # Noise-only capture: level stays below squelch -> gated audio == 0.
    src = SyntheticSource(FS, rx.block_len, [], noise=1e-5)
    step = jax.jit(rx.apply)
    state = rx.init_state()
    for _ in range(10):
        state, out = step(state, (jnp.asarray(next(src)), controls))
    g = out["groups"][0]
    assert bool(np.asarray(g["squelched"])[0])
    assert float(np.abs(np.asarray(g["audio"])).max()) == 0.0
    # Strong station appears -> squelch opens.
    src2 = SyntheticSource(FS, rx.block_len,
                           [Station(300e3, "fm", audio_freq=1000.0)])
    for _ in range(10):
        state, out = step(state, (jnp.asarray(next(src2)), controls))
    assert not bool(np.asarray(out["groups"][0]["squelched"])[0])


def test_mixed_modem_groups():
    """FM + AM demods in one pipeline; both recover their audio."""
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 300e3, "FM", 200000)
    mgr.new_demodulator(100e6 - 250e3, "AM", 6000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(FS, specs)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)
    stations = [Station(300e3, "fm", audio_freq=1000.0),
                Station(-250e3, "am", audio_freq=700.0, mod_index=0.8)]
    src = SyntheticSource(FS, rx.block_len, stations, noise=1e-4)
    step = jax.jit(rx.apply)
    state = rx.init_state()
    outs = []
    for _ in range(int(0.7 * FS / rx.block_len)):
        state, o = step(state, (jnp.asarray(next(src)), controls))
        outs.append(o)
    names = [s.modem_name for s in rx.groups]
    fm_gi, am_gi = names.index("FM"), names.index("AM")
    fm = np.concatenate(
        [np.asarray(o["groups"][fm_gi]["audio"][0, 0]) for o in outs])
    am = np.concatenate(
        [np.asarray(o["groups"][am_gi]["audio"][0, 0]) for o in outs])
    assert tone_snr(fm[9600:], 1000.0, 48000) > 30
    assert tone_snr(am[19200:], 700.0, 48000) > 25


class TestManager:
    def test_navigation_and_hits(self):
        mgr = DemodulatorMgr()
        a = mgr.new_demodulator(100e6, "FM")
        b = mgr.new_demodulator(101e6, "FM")
        c = mgr.new_demodulator(99e6, "FM")
        assert mgr.get_first_demodulator() is c
        assert mgr.get_last_demodulator() is b
        assert mgr.get_next_demodulator(a) is b
        assert mgr.get_previous_demodulator(a) is c
        hits = mgr.get_demodulators_at(100e6 + 50e3)
        assert hits == [a]

    def test_last_state_defaults(self):
        mgr = DemodulatorMgr()
        a = mgr.new_demodulator(100e6, "NBFM", 12500)
        a.squelch_level = -40.0
        a.squelch_enabled = True
        mgr.set_active_demodulator(a, temporary=False)
        b = mgr.new_demodulator(101e6)
        assert b.demod_type == "NBFM"
        assert b.bandwidth == 12500
        assert b.squelch_enabled and b.squelch_level == -40.0

    def test_save_load_roundtrip(self):
        mgr = DemodulatorMgr()
        d = mgr.new_demodulator(100e6, "USB", 5400)
        d.user_label = "net"
        d.gain = 1.5
        saved = mgr.save_instances()
        mgr2 = DemodulatorMgr()
        mgr2.load_instances(saved)
        d2 = mgr2.get_demodulators()[0]
        assert d2.demod_type == "USB" and d2.user_label == "net"
        assert d2.gain == 1.5 and d2.frequency == 100e6
