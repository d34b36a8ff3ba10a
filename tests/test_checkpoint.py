"""Bit-continuous resume: checkpoint mid-stream, restore, outputs identical
to an uninterrupted run (the distinctive upgrade over the reference's
settings-only sessions)."""

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.app.checkpoint import save_state, load_state
from cubicsdr.io.audio_out import AudioOutput
from cubicsdr.io.sources import SyntheticSource, Station
from cubicsdr.io.wav import read_wav
from cubicsdr.receiver import (
    DemodulatorMgr, ReceiverPipeline, plan_from_manager,
    controls_from_manager)


def test_bit_continuous_resume(tmp_path):
    fs = 1_000_000
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(fs, specs)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)
    src = SyntheticSource(fs, rx.block_len,
                          [Station(200e3, "fm", audio_freq=900.0)])
    blocks = [next(src) for _ in range(6)]
    step = jax.jit(rx.apply)

    # Uninterrupted run.
    state = rx.init_state()
    ref = []
    for b in blocks:
        state, out = step(state, (jnp.asarray(b), controls))
        ref.append(np.asarray(out["groups"][0]["audio"]))

    # Run 3 blocks, checkpoint, new process-sim restore, run remaining 3.
    state = rx.init_state()
    for b in blocks[:3]:
        state, out = step(state, (jnp.asarray(b), controls))
    p = str(tmp_path / "ckpt.npz")
    save_state(p, state, meta={"block": 3})
    state2, meta = load_state(p, rx.init_state())
    assert meta["block"] == 3
    got = []
    for b in blocks[3:]:
        state2, out = step(state2, (jnp.asarray(b), controls))
        got.append(np.asarray(out["groups"][0]["audio"]))
    for g, r in zip(got, ref[3:]):
        np.testing.assert_allclose(g, r, atol=1e-6)


def test_checkpoint_shape_mismatch_detected(tmp_path):
    fs = 1_000_000
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(fs, specs)
    p = str(tmp_path / "c.npz")
    save_state(p, rx.init_state())
    mgr.new_demodulator(100e6 - 200e3, "FM", 200000)   # plan changed
    specs2, _ = plan_from_manager(mgr)
    rx2 = ReceiverPipeline(fs, specs2)
    try:
        load_state(p, rx2.init_state())
        assert False, "should detect shape mismatch"
    except AssertionError as e:
        assert "plan changed" in str(e) or "shape" in str(e)


def test_audio_output_degrades_to_wav_and_null(tmp_path):
    out = AudioOutput(48000, 1, backend=f"wav:{tmp_path}/play")
    out.write(np.ones(480, np.float32) * 0.1)
    out.close()
    d, rate = read_wav(str(tmp_path / "play.wav"))
    assert d.shape == (1, 480)
    # headless auto -> null or sounddevice; either way write must not raise
    o2 = AudioOutput(48000, 2, backend="auto")
    o2.write(np.zeros((2, 480), np.float32))
    o2.close()
    assert o2.backend in ("null", "sounddevice")
