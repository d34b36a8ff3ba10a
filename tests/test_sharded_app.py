"""The sharded receiver as an APPLICATION (SURVEY §7 step 7): `rx --mesh`
drives ShardedReceiver end-to-end on the 8-device CPU mesh — WAV mix from
the psum, waterfall PNG from the all-gather spectrum, per-demod recording
taps, and bit-continuous checkpoint save/resume of the placed state."""

import os
import wave

import numpy as np

from cubicsdr.app.cli import main
from cubicsdr.app.session import SessionMgr
from cubicsdr.receiver import DemodulatorMgr

FS = 1_000_000


def _make_session(path):
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 150e3, "FM", 200000)
    mgr.new_demodulator(100e6 - 150e3, "FM", 200000)
    sess = SessionMgr(mgr)
    sess.center_freq = 100_000_000
    sess.sample_rate = FS
    sess.save_session(str(path))
    return str(path)


def _capture_iq(n_samples):
    t = np.arange(n_samples) / FS
    msg = np.sin(2 * np.pi * 800.0 * t)
    return (0.8 * np.exp(1j * (2 * np.pi * 150e3 * t
                               + 2 * np.pi * 75e3 * np.cumsum(msg) / FS))
            + 0.4 * np.exp(2j * np.pi * -150e3 * t)).astype(np.complex64)


def _make_capture(path, n_samples):
    iq = _capture_iq(n_samples)
    iq.tofile(str(path))
    return str(path)


def _block_len():
    # The block size the sharded plan will pick for this session shape.
    import jax
    from cubicsdr.parallel import make_receiver_mesh
    from cubicsdr.parallel.sharded import ShardedReceiver
    from cubicsdr.receiver import DemodGroupSpec
    from cubicsdr.io.sources import optimal_channel_count
    mesh = make_receiver_mesh(n_time=4, n_chan=2,
                              devices=jax.devices()[:8])
    return ShardedReceiver(
        FS, num_channels=optimal_channel_count(FS),
        groups=[DemodGroupSpec("FM", 200000, 2)], mesh=mesh).block_len


def test_rx_mesh_end_to_end(tmp_path):
    L = _block_len()
    sess = _make_session(tmp_path / "s.json")
    cap = _make_capture(tmp_path / "c.cf32", 2 * L)
    out = str(tmp_path / "mix.wav")
    ck = str(tmp_path / "state.npz")
    rec = str(tmp_path / "rec")
    rc = main(["rx", sess, cap, "-o", out, "--mesh", "time=4,chan=2",
               "--checkpoint", ck, "--record", rec])
    assert not rc
    w = wave.open(out)
    assert w.getnchannels() == 2 and w.getnframes() > 0
    png = out.rsplit(".", 1)[0] + "_waterfall.png"
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.exists(ck)
    # Per-demod recording taps (2 FM rows).
    recs = [p for p in os.listdir(tmp_path) if p.startswith("rec_demod")]
    assert len(recs) == 2


def test_rx_mesh_checkpoint_resume_is_bit_continuous(tmp_path):
    """Stopping after block 1 and resuming from the checkpoint must produce
    the SAME audio for block 2 as the uninterrupted run (sharded placed
    state round-trips through the snapshot)."""
    L = _block_len()
    sess = _make_session(tmp_path / "s.json")
    iq = _capture_iq(2 * L)
    cap_all, cap_1, cap_2 = (str(tmp_path / p)
                             for p in ("all.cf32", "b1.cf32", "b2.cf32"))
    iq.tofile(cap_all)
    iq[:L].tofile(cap_1)
    iq[L:].tofile(cap_2)

    out_all = str(tmp_path / "all.wav")
    assert not main(["rx", sess, cap_all, "-o", out_all,
                     "--mesh", "time=4,chan=2"])
    ck = str(tmp_path / "ck.npz")
    assert not main(["rx", sess, cap_1, "-o", str(tmp_path / "p1.wav"),
                     "--mesh", "time=4,chan=2", "--checkpoint", ck])
    assert not main(["rx", sess, cap_2, "-o", str(tmp_path / "p2.wav"),
                     "--mesh", "time=4,chan=2", "--checkpoint", ck])

    def pcm(p):
        w = wave.open(p)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")

    a_all = pcm(out_all)
    a_resumed = np.concatenate([pcm(str(tmp_path / "p1.wav")),
                                pcm(str(tmp_path / "p2.wav"))])
    assert a_all.shape == a_resumed.shape
    # 16-bit PCM: allow +-1 LSB of float round-off.
    assert np.max(np.abs(a_all.astype(int) - a_resumed.astype(int))) <= 1
