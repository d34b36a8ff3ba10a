"""LiveReceiver end-to-end: producer thread -> ring -> compiled step ->
recorders + waterfall + metrics. Plus device enumeration and rig control
(ref: src/CubicSDR.cpp wiring, src/sdr/SDREnumerator.*, src/rig/RigThread.*).
"""

import numpy as np
import pytest

from cubicsdr.app.rig import (
    SimulatedRig, RigController, RigError, RigIOError)
from cubicsdr.io.devices import SDREnumerator, SDRDeviceInfo
from cubicsdr.io.sources import SyntheticSource, Station
from cubicsdr.io.wav import read_wav
from cubicsdr.receiver import (
    DemodulatorMgr, ReceiverPipeline, plan_from_manager,
    controls_from_manager)


@pytest.mark.parametrize("dtype", ["complex", "planar"])
def test_live_receiver_records_and_draws(tmp_path, dtype):
    import jax.numpy as jnp
    from cubicsdr.ops.planar import PLANAR
    from cubicsdr.app.runner import LiveReceiver
    fs = 1_000_000
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(
        fs, specs, dtype=PLANAR if dtype == "planar" else jnp.complex64)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)

    class _FiniteSource:
        def __init__(self, n):
            self.src = SyntheticSource(fs, rx.block_len, [
                Station(200e3, "fm", audio_freq=1000.0)])
            self.n = n

        def __iter__(self):
            for _ in range(self.n):
                yield next(self.src)

    lr = LiveReceiver(rx, controls, _FiniteSource(12),
                      record_path=str(tmp_path / "rec"),
                      waterfall_fft=256, waterfall_lines=32)
    lr.start_producer()
    n = lr.run_blocks()
    lr.stop()
    assert n == 12
    d, rate = read_wav(str(tmp_path / "rec_demod0.wav"))
    assert rate == 48000 and d.shape[1] == 12 * rx.audio_len
    a = d[0, 9600:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f = np.fft.rfftfreq(len(a), 1 / 48000)
    assert abs(f[spec.argmax()] - 1000.0) < 15
    # Waterfall received lines; metrics ticked.
    assert lr.waterfall.buffer.max() > 0
    snap = lr.metrics.snapshot()
    assert snap["pipeline"]["blocks"] == 12
    assert snap["ingest"]["dropped"] == 0


def test_enumerator_backends():
    en = SDREnumerator()
    en.add_remote("tcp://sdr.example:55132")
    en.set_manuals([{"driver": "rtltcp", "label": "Manual RTL"}])
    devs = en.enumerate_devices()
    ids = [d.device_id for d in devs]
    assert "synthetic=0" in ids
    assert any(d.remote for d in devs)
    assert any(d.manual for d in devs)
    d = devs[0]
    assert d.get_rate_near(2_300_000) == 2_400_000
    assert len(d.get_sample_rates()) <= 25


def test_rig_modes():
    rig = SimulatedRig(14.074e6)
    app = {"freq": 14.074e6}
    rc = RigController(rig, lambda: app["freq"],
                       lambda f: app.__setitem__("freq", f))
    rc.poll()                       # establish baseline
    # follow: rig moves -> app follows
    rig.frequency = 14.2e6
    assert rc.poll() == RigError.OK
    assert app["freq"] == 14.2e6
    # control: app moves -> rig follows
    app["freq"] = 7.1e6
    rc.poll()
    assert rig.frequency == 7.1e6
    # center lock: rig moves, app stays
    rc.center_lock = True
    rig.frequency = 7.2e6
    rc.poll()
    assert app["freq"] == 7.1e6
    # follow-modem: rig tracks the modem frequency
    rc.center_lock = False
    rc.follow_modem = True
    rc.poll(modem_freq=7.3e6)
    assert rig.frequency == 7.3e6
    # error surfacing
    rig.fail_with = RigError.TIMEOUT
    assert rc.poll() == RigError.TIMEOUT
    assert RigError.TIMEOUT.message() == "Rig communication timed out"


def test_native_format_ingest_int16_matches_f32():
    """Native-format ingest (the CS16 hardware path): int16 wire planes
    through the ring, converted to f32 ON DEVICE by the compiled step.
    Audio must match the f32 path within 16-bit quantization noise, and
    the visual/waterfall chain must run from the converted tap."""
    import jax.numpy as jnp
    from cubicsdr.ops.planar import PLANAR
    from cubicsdr.app.runner import LiveReceiver
    fs = 1_000_000
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(fs, specs, dtype=PLANAR)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)
    src = SyntheticSource(fs, rx.block_len,
                          [Station(200e3, "fm", audio_freq=1000.0)])
    blocks = [next(src) for _ in range(4)]   # complex64 blocks, |x| <~ 1

    def run(ingest_dtype, blks):
        got = []
        lr = LiveReceiver(rx, controls, iter(blks), waterfall_fft=256,
                          waterfall_lines=16, ingest_dtype=ingest_dtype,
                          on_block=lambda o: got.append(o))
        lr.start_producer()
        n = lr.run_blocks()
        lr.stop()
        assert n == len(blks)
        assert np.abs(lr.waterfall.buffer).sum() > 0   # visual chain ran
        return got

    got_f32 = run(None, list(blocks))
    # int16 source blocks: pre-quantized planes, exactly what the ring
    # receives from a CS16 SoapySDR stream.
    i16 = [np.stack([
        np.clip(b.real * 32768, -32768, 32767).astype(np.int16),
        np.clip(b.imag * 32768, -32768, 32767).astype(np.int16)])
        for b in blocks]
    got_i16 = run(np.int16, i16)

    for a, b in zip(got_f32, got_i16):
        # FM discriminates phase, so 16-bit amplitude quantization stays
        # tiny in the audio; levels within a fraction of a dB.
        np.testing.assert_allclose(a["mix"], b["mix"], atol=2e-3)
        np.testing.assert_allclose(a["groups"][0]["level"],
                                   b["groups"][0]["level"], atol=0.1)


def test_raw_source_into_f32_ring_normalizes():
    """A CS16 SoapySDR stream (int16 planes) feeding the default f32
    ingest must be scaled to ±1, not cast hot (a bare int->float cast is
    32768x the correct amplitude)."""
    import jax.numpy as jnp
    from cubicsdr.ops.planar import PLANAR
    from cubicsdr.app.runner import LiveReceiver
    fs = 1_000_000
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(fs, specs, dtype=PLANAR)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)
    src = SyntheticSource(fs, rx.block_len,
                          [Station(200e3, "fm", audio_freq=1000.0)])
    blocks = [next(src) for _ in range(3)]
    i16 = [np.stack([
        np.clip(b.real * 32768, -32768, 32767).astype(np.int16),
        np.clip(b.imag * 32768, -32768, 32767).astype(np.int16)])
        for b in blocks]

    got = []
    lr = LiveReceiver(rx, controls, iter(i16),
                      on_block=lambda o: got.append(o),
                      waterfall_fft=256, waterfall_lines=8)
    lr.start_producer()
    assert lr.run_blocks() == 3
    lr.stop()
    lv = float(got[-1]["groups"][0]["level"][0])
    # Properly normalized FM station measures ~-6 dB, not +84 dB.
    assert -30 < lv < 10, lv


def test_native_format_ingest_int8_end_to_end():
    """CS8 (RTL-SDR class hardware): 8-bit planes through ring + device,
    FM still decodes its tone (8-bit IQ SNR floor, not a scaling bug)."""
    import jax.numpy as jnp
    from cubicsdr.ops.planar import PLANAR
    from cubicsdr.app.runner import LiveReceiver
    fs = 1_000_000
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(fs, specs, dtype=PLANAR)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)
    src = SyntheticSource(fs, rx.block_len,
                          [Station(200e3, "fm", audio_freq=1000.0)])
    i8 = [np.stack([
        np.clip(b.real * 128, -128, 127).astype(np.int8),
        np.clip(b.imag * 128, -128, 127).astype(np.int8)])
        for b in (next(src) for _ in range(4))]

    got = []
    lr = LiveReceiver(rx, controls, iter(i8), ingest_dtype=np.int8,
                      on_block=lambda o: got.append(o),
                      waterfall_fft=256, waterfall_lines=8)
    assert lr.ring.dtype == np.int8
    lr.start_producer()
    assert lr.run_blocks() == 4
    lr.stop()
    audio = np.concatenate([o["mix"][0] for o in got[1:]])
    w = np.hanning(len(audio))
    X = np.abs(np.fft.rfft(audio * w)) ** 2
    f = np.fft.rfftfreq(len(audio), 1 / 48000)
    k = int(np.argmax(X))
    assert abs(f[k] - 1000.0) < 10          # tone survives 8-bit IQ
    sig = X[k - 2: k + 3].sum()
    snr = 10 * np.log10(sig / (X.sum() - sig))
    assert snr > 25, snr
