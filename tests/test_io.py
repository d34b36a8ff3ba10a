"""IO: WAV round-trip + rollover, IQ file formats, recorder policies,
device-layer batching constants (ref: src/audio/AudioFileWAV.cpp,
src/audio/AudioSinkFileThread.cpp, src/sdr/SoapySDRThread.cpp:668-693)."""

import numpy as np
import pytest

from cubicsdr.io import (
    WavWriter, write_wav, read_wav, FileIQSource, SyntheticSource,
    RecordingSink, SquelchOption, optimal_block_len, optimal_channel_count)
from cubicsdr.io.sources import Station


def test_wav_roundtrip(tmp_path):
    data = np.sin(2 * np.pi * 440 * np.arange(4800) / 48000).astype(
        np.float32)
    p = str(tmp_path / "t.wav")
    write_wav(p, data, 48000)
    got, rate = read_wav(p)
    assert rate == 48000 and got.shape == (1, 4800)
    np.testing.assert_allclose(got[0], data, atol=1e-4)


def test_wav_stereo_and_rollover(tmp_path):
    w = WavWriter(str(tmp_path / "s"), 48000, channels=2, max_bytes=4000)
    blk = np.ones((2, 400), np.float32) * 0.5
    for _ in range(5):
        w.write(blk)                      # 1600 B each -> rollover after 2
    w.close()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert "s.wav" in files and "s-1.wav" in files
    d0, _ = read_wav(str(tmp_path / "s.wav"))
    assert d0.shape[0] == 2


def test_iq_file_formats(tmp_path):
    x = (np.arange(64) + 1j * np.arange(64, 128)).astype(np.complex64) / 256
    inter = np.empty(128, np.float32)
    inter[0::2], inter[1::2] = x.real, x.imag
    p = tmp_path / "cap.cf32"
    inter.tofile(p)
    src = FileIQSource(str(p), 1e6, 16)
    blocks = list(src)
    assert len(blocks) == 4
    np.testing.assert_allclose(np.concatenate(blocks), x, atol=1e-6)
    # int16 format
    p2 = tmp_path / "cap.cs16"
    (inter * 32768).astype(np.int16).tofile(p2)
    src2 = FileIQSource(str(p2), 1e6, 32)
    np.testing.assert_allclose(
        np.concatenate(list(src2)), x, atol=1e-3)


def test_synthetic_source_phase_continuity():
    src = SyntheticSource(1e6, 1000, [Station(100e3, "tone")])
    a = np.concatenate([next(src), next(src)])
    src2 = SyntheticSource(1e6, 2000, [Station(100e3, "tone")])
    b = next(src2)
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_recorder_squelch_policies(tmp_path):
    audio = np.ones((1, 100), np.float32) * 0.25
    for opt, expect_frames, expect_zero in [
            (SquelchOption.RECORD_SILENCE, 200, True),
            (SquelchOption.SKIP_SILENCE, 100, False),
            (SquelchOption.RECORD_ALWAYS, 200, False)]:
        base = str(tmp_path / f"r{int(opt)}")
        sink = RecordingSink(base, 48000, 1, squelch_option=opt)
        sink.write(audio, squelched=False)
        sink.write(audio, squelched=True)
        sink.close()
        d, _ = read_wav(base + ".wav")
        assert d.shape[1] == expect_frames
        if expect_zero:
            assert np.abs(d[0, 100:]).max() == 0.0


def test_recorder_time_rotation(tmp_path):
    clock = iter([0.0, 0.0, 10.0, 10.0, 10.0]).__next__
    names = iter(["A", "B"]).__next__
    sink = RecordingSink(str(tmp_path / "rot"), 48000, 1,
                         time_limit_s=5.0, clock=clock, timestamp_fn=names)
    sink.write(np.ones((1, 10), np.float32))
    sink.write(np.ones((1, 10), np.float32))   # clock jumped past limit
    sink.close()
    files = {p.name for p in tmp_path.iterdir()}
    assert files == {"rot.wav", "rot_A.wav"}


def test_device_constants():
    # ceil(rate/500k) forced even, min 2 (ref: SoapySDRThread.cpp:676-693).
    assert optimal_channel_count(2.5e6) == 6
    assert optimal_channel_count(2.0e6) == 4
    assert optimal_channel_count(1e6) == 2
    assert optimal_channel_count(10e6) == 20
    assert optimal_channel_count(3.2e6) == 8   # ceil=7 -> 8
    # rate/60 rounded to multiple.
    assert optimal_block_len(2.4e6, 16) % 16 == 0
    assert abs(optimal_block_len(2.4e6, 16) - 40000) < 16
