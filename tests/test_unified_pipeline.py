"""The unified ReceiverPipeline: ONE class, both representations, all modem
kinds.

- planar (dtype=PLANAR) pipeline == complex64 pipeline on a mixed analog farm
- digital groups ride the same pipeline: FSK symbols decode through
  channelizer -> frontend -> kit with level metering on IQ
  (ref: src/demod/DemodulatorThread.cpp:140 runs every modem through the
  same thread; ModemDigital.cpp:56-83 emits symbols instead of audio).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cubicsdr.io.sources import SyntheticSource, Station
from cubicsdr.ops.planar import PLANAR, from_complex
from cubicsdr.receiver import ReceiverPipeline, DemodGroupSpec

FS = 2_000_000


def _controls(rx, freqs_by_group):
    controls = rx.control_template()
    for ctl, freqs in zip(controls, freqs_by_group):
        ctl["frequency"] = np.asarray(freqs, np.float32)
    return controls


def test_planar_pipeline_matches_complex():
    specs = [DemodGroupSpec("FM", 200000, 2),
             DemodGroupSpec("AM", 6000, 1)]
    freqs = [[300e3, -450e3], [120e3]]
    stations = [Station(300e3, "fm", audio_freq=1000.0, deviation=75e3),
                Station(-450e3, "fm", audio_freq=2000.0, deviation=75e3),
                Station(120e3, "am", audio_freq=800.0)]

    rx_c = ReceiverPipeline(FS, specs, dtype=jnp.complex64)
    rx_p = ReceiverPipeline(FS, specs, dtype=PLANAR)
    assert rx_c.block_len == rx_p.block_len

    src = SyntheticSource(FS, rx_c.block_len, stations, noise=1e-4)
    ctls = _controls(rx_c, freqs)

    step_c = jax.jit(rx_c.apply)
    step_p = jax.jit(rx_p.apply)
    st_c, st_p = rx_c.init_state(), rx_p.init_state()
    for _ in range(4):
        iq = next(src)
        st_c, out_c = step_c(st_c, (jnp.asarray(iq), ctls))
        st_p, out_p = step_p(st_p, (from_complex(iq), ctls))
        np.testing.assert_allclose(out_p["mix"], out_c["mix"],
                                   atol=2e-3, rtol=2e-3)
        for g_c, g_p in zip(out_c["groups"], out_p["groups"]):
            np.testing.assert_allclose(g_p["audio"], g_c["audio"],
                                       atol=2e-3, rtol=2e-3)
            np.testing.assert_allclose(g_p["level"], g_c["level"], atol=0.1)


def _fsk_capture(f_station, bw_rate, sps, n_runs, frames_per_run, seed=0):
    """Phase-continuous binary FSK at FS: each data bit held for
    frames_per_run FSK symbol frames (k = bw_rate/sps samples each)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_runs)
    k = bw_rate // sps
    # FSKKit tone map for m=2, bw=0.45: f = (i - 0.5) * 0.45 * bw_rate.
    tone = (bits - 0.5) * 0.45 * bw_rate
    # Per-FS-sample frequency.
    samples_per_run = int(frames_per_run * k * FS // bw_rate)
    f_t = np.repeat(f_station + tone, samples_per_run)
    phase = 2 * np.pi * np.cumsum(f_t) / FS
    return np.exp(1j * phase).astype(np.complex64), bits


@pytest.mark.parametrize("dtype", ["complex", "planar"])
def test_fsk_decodes_through_pipeline(dtype):
    sps, bw = 1200, 19200
    specs = [DemodGroupSpec("FSK", bw, 1,
                            settings=(("bps", 1), ("sps", sps)))]
    rx = ReceiverPipeline(
        FS, specs, dtype=PLANAR if dtype == "planar" else jnp.complex64)
    assert rx.is_digital == [True]

    f_station = 310e3
    iq, bits = _fsk_capture(f_station, bw, sps, n_runs=40,
                            frames_per_run=16)
    ctls = _controls(rx, [[f_station]])
    step = jax.jit(rx.apply)
    state = rx.init_state()
    syms = []
    n_blocks = len(iq) // rx.block_len
    for b in range(n_blocks):
        blk = iq[b * rx.block_len:(b + 1) * rx.block_len]
        x = from_complex(blk) if dtype == "planar" else jnp.asarray(blk)
        state, out = step(state, (x, ctls))
        g = out["groups"][0]
        # Digital group contract: symbols + evm + locked + IQ-metered level,
        # and no audio in the mix path.
        assert "symbols" in g and "evm" in g and "locked" in g
        assert "audio" not in g
        syms.append(np.asarray(g["symbols"][0]))
    decoded = np.concatenate(syms).astype(float) - 0.5
    sent = np.repeat(bits.astype(float) - 0.5, 16)   # one vote per frame

    # Chain delay (channelizer + resampler group delay) shifts the symbol
    # stream; find it by correlation, then demand high accuracy.
    best_acc, best_d = 0.0, 0
    for d in range(0, 64):
        n = min(len(decoded) - d, len(sent))
        acc = np.mean(np.sign(decoded[d:d + n]) == np.sign(sent[:n]))
        if acc > best_acc:
            best_acc, best_d = acc, d
    assert best_acc > 0.95, (best_acc, best_d)


def test_mixed_analog_digital_plan():
    """An FM + BPSK session in ONE compiled step: the analog group feeds the
    mix, the digital group emits symbols; a dict fed into the squelch
    gate once crashed this plan."""
    specs = [DemodGroupSpec("FM", 200000, 1),
             DemodGroupSpec("BPSK", 19200, 1)]
    rx = ReceiverPipeline(FS, specs, dtype=PLANAR)
    assert rx.is_digital == [False, True]

    stations = [Station(300e3, "fm", audio_freq=1000.0, deviation=75e3),
                Station(-200e3, "tone")]
    src = SyntheticSource(FS, rx.block_len, stations, noise=1e-4)
    ctls = _controls(rx, [[300e3], [-200e3]])

    step = jax.jit(rx.apply)
    state = rx.init_state()
    for _ in range(3):
        state, out = step(state, (from_complex(next(src)), ctls))
    fm, dig = out["groups"]
    assert fm["audio"].shape[-2] == 1
    assert out["mix"].shape[-2] == 2
    assert dig["symbols"].dtype == np.int32
    # Signal meter must register the digital station's carrier.
    assert float(dig["level"][0]) > -40.0


def test_gmsk_decodes_through_pipeline():
    """GMSK end-to-end (channelizer -> frontend -> integrate-and-dump,
    ref: ModemGMSK.cpp:95-134): phase-continuous MSK-style capture at FS,
    bits held 4 symbol frames (no clock recovery in the chain)."""
    bw, sps, HOLD = 20000, 4, 4
    specs = [DemodGroupSpec("GMSK", bw, 1, settings=(("sps", sps),))]
    rx = ReceiverPipeline(FS, specs, dtype=PLANAR)
    assert rx.is_digital == [True]

    rng = np.random.default_rng(5)
    f_station = 310e3
    n_blocks = 3
    n = n_blocks * rx.block_len
    spb = HOLD * sps * int(FS // bw)         # capture samples per bit
    bits = rng.integers(0, 2, n // spb + 1)
    # MSK tone map at the kit rate: f = +-0.25/sps cycles/sample @ bw.
    f_hz = (bits * 2 - 1) * (0.25 / sps) * bw
    f_t = np.repeat(f_station + f_hz, spb)[:n]
    iq = np.exp(1j * 2 * np.pi * np.cumsum(f_t) / FS).astype(np.complex64)

    ctls = _controls(rx, [[f_station]])
    step = jax.jit(rx.apply)
    state = rx.init_state()
    syms = []
    for b in range(n_blocks):
        blk = iq[b * rx.block_len:(b + 1) * rx.block_len]
        state, out = step(state, (from_complex(blk), ctls))
        g = out["groups"][0]
        assert "symbols" in g and "audio" not in g
        syms.append(np.asarray(g["symbols"][0]))
    dec = np.concatenate(syms).astype(float) - 0.5
    sent = np.repeat(bits.astype(float) - 0.5, HOLD)
    best = 0.0
    for d in range(0, 64):
        m = min(len(dec) - d, len(sent))
        best = max(best, np.mean(
            np.sign(dec[d:d + m]) == np.sign(sent[:m])))
    assert best > 0.9, best
