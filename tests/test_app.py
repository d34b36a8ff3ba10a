"""App shell: config/session/bookmark persistence + CLI parsing
(ref: src/AppConfig.*, src/SessionMgr.*, src/BookmarkMgr.*, src/CubicSDR.cpp
frequency helpers)."""

import json
import os

import numpy as np
import pytest

from cubicsdr.app import AppConfig, DeviceConfig, SessionMgr, BookmarkMgr
from cubicsdr.app.bookmarks import BookmarkEntry, BookmarkRange
from cubicsdr.app.cli import parse_frequency, format_frequency
from cubicsdr.receiver import DemodulatorMgr


def test_config_roundtrip(tmp_path):
    cfg = AppConfig(theme="jet", center_freq=98_500_000, waterfall_lps=60)
    dev = cfg.get_device("rtl=0")
    dev.ppm = -2
    dev.gains = {"TUNER": 30.5}
    p = str(tmp_path / "config.json")
    cfg.save(p)
    cfg2 = AppConfig.load(p)
    assert cfg2.theme == "jet" and cfg2.center_freq == 98_500_000
    assert cfg2.get_device("rtl=0").ppm == -2
    assert cfg2.get_device("rtl=0").gains["TUNER"] == 30.5


def test_session_roundtrip(tmp_path):
    mgr = DemodulatorMgr()
    d = mgr.new_demodulator(100e6, "NBFM", 12500)
    d.squelch_enabled = True
    sess = SessionMgr(mgr)
    sess.center_freq = 100_000_000
    sess.sample_rate = 2_400_000
    sess.solo_mode = True
    p = str(tmp_path / "s.json")
    sess.save_session(p)

    mgr2 = DemodulatorMgr()
    sess2 = SessionMgr(mgr2)
    assert sess2.load_session(p, supported_rates=[2_000_000, 2_500_000])
    assert sess2.center_freq == 100_000_000
    assert sess2.sample_rate == 2_500_000       # clamped to capability
    assert sess2.solo_mode
    d2 = mgr2.get_demodulators()[0]
    assert d2.demod_type == "NBFM" and d2.squelch_enabled


def test_bookmarks_groups_recents_recovery(tmp_path):
    bm = BookmarkMgr()
    e = BookmarkEntry(label="WX", frequency=162.55e6, demod_type="NBFM")
    bm.add_bookmark("weather", e)
    bm.add_range(BookmarkRange("FM band", 98e6, 88e6, 108e6))
    for i in range(30):
        bm.add_recent(BookmarkEntry(label=f"r{i}", frequency=1e6 * i))
    assert len(bm.recents) == 25                # capped

    p = str(tmp_path / "bookmarks.json")
    bm.save_to_file(p)
    bm.save_to_file(p)                          # second save -> .backup
    assert os.path.exists(p + ".backup")

    bm2 = BookmarkMgr()
    assert bm2.load_from_file(p)
    assert bm2.get_bookmarks("weather")[0].frequency == 162.55e6
    assert os.path.exists(p + ".lastloaded")

    # Corrupt main file -> recovery via .lastloaded.
    with open(p, "w") as f:
        f.write("{corrupt")
    bm3 = BookmarkMgr()
    assert bm3.load_from_file(p)
    assert bm3.get_bookmarks("weather")[0].label == "WX"

    bm.move_bookmark(e, "weather", "favs")
    assert bm.get_bookmarks("weather") == []
    assert bm.get_bookmarks("favs")[0].label == "WX"


@pytest.mark.parametrize("s,expect", [
    ("100.1", 100.1e6), ("100.1M", 100.1e6), ("98700k", 98.7e6),
    ("2.4G", 2.4e9), ("146520000", 146520000.0), ("455k", 455000.0),
])
def test_parse_frequency(s, expect):
    assert parse_frequency(s) == pytest.approx(expect)


def test_format_frequency():
    assert format_frequency(100.1e6) == "100.100000 MHz"
    assert format_frequency(455e3) == "455.000 kHz"


def test_cli_end_to_end(tmp_path):
    """Full CLI drive: synth capture file -> demod subcommand -> WAV."""
    from cubicsdr.io.sources import SyntheticSource, Station
    from cubicsdr.io.wav import read_wav
    from cubicsdr.app.cli import main

    src = SyntheticSource(1e6, 1 << 18,
                          [Station(200e3, "fm", audio_freq=1000.0,
                                   deviation=5e3)])
    cap = np.concatenate([next(src) for _ in range(4)])
    inter = np.empty(2 * len(cap), np.float32)
    inter[0::2], inter[1::2] = cap.real, cap.imag
    p = str(tmp_path / "cap.cf32")
    inter.tofile(p)
    out = str(tmp_path / "audio.wav")
    rc = main(["demod", p, "-r", "1000000", "-f", "200k",
               "-m", "NBFM", "-b", "12500", "-o", out])
    assert rc == 0
    d, rate = read_wav(out)
    assert rate == 48000 and d.shape[1] > 40000
    a = d[0, 9600:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f = np.fft.rfftfreq(len(a), 1 / 48000)
    assert abs(f[spec.argmax()] - 1000.0) < 10
