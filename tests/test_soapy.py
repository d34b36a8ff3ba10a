"""SoapySDRSource against a mock driver: MTU chunking, overflow carry,
rate renegotiation, staged-settings atomics, device-loss surfacing
(ref: src/sdr/SoapySDRThread.cpp:63-171, 195-345, 405-433, 447-604)."""

import numpy as np
import pytest

from cubicsdr.io.soapy import (
    SoapySDRSource, DeviceLostError, optimal_element_count,
    SOAPY_SDR_TIMEOUT)


class _MockReturn:
    def __init__(self, ret):
        self.ret = ret


class _MockDevice:
    """Deterministic CF32 counter stream: sample k = (k, -k)/1e6. Lets the
    tests verify bit-exact reassembly across chunk/overflow boundaries."""

    def __init__(self, args):
        self.args = args
        self.mtu = 1000
        self.applied_rate_factor = 1.0       # device may force another rate
        self.k = 0
        self.active = False
        self.calls = []                      # (method, args) log
        self.fail_after_reads = None
        self.block_after_reads = None
        self._reads = 0

    # --- stream plumbing ---
    def setupStream(self, direction, fmt, chans, args):
        assert fmt == "CF32"
        return object()

    def getStreamMTU(self, stream):
        return self.mtu

    def activateStream(self, stream):
        self.active = True

    def deactivateStream(self, stream):
        self.active = False

    def closeStream(self, stream):
        pass

    # --- settings ---
    def setSampleRate(self, rx, ch, rate):
        self.calls.append(("rate", rate))
        self._rate = rate * self.applied_rate_factor

    def getSampleRate(self, rx, ch):
        return self._rate

    def setFrequency(self, rx, ch, kind, freq):
        self.calls.append(("freq", kind, freq))

    def setFrequencyCorrection(self, rx, ch, ppm):
        self.calls.append(("ppm", ppm))

    def hasGainMode(self, rx, ch):
        return True

    def setGainMode(self, rx, ch, agc):
        self.calls.append(("agc", agc))

    def setGain(self, rx, ch, name, v):
        self.calls.append(("gain", name, v))

    def writeSetting(self, k, v):
        self.calls.append(("setting", k, v))

    # --- data ---
    def readStream(self, stream, buffs, num, timeoutUs=0):
        assert self.active
        self._reads += 1
        if self.fail_after_reads is not None \
                and self._reads > self.fail_after_reads:
            return _MockReturn(-2)           # SOAPY_SDR_STREAM_ERROR
        if self.block_after_reads is not None \
                and self._reads > self.block_after_reads:
            return _MockReturn(0)
        n = min(num, self.mtu)
        k = self.k + np.arange(n)
        buffs[0][0: 2 * n: 2] = k / 1e6
        buffs[0][1: 2 * n: 2] = -k / 1e6
        self.k += n
        return _MockReturn(n)


class _MockModule:
    SOAPY_SDR_RX = 0
    Device = _MockDevice


def _make(block_len=2_048, **kw):
    return SoapySDRSource("driver=mock", sample_rate=2_400_000,
                          frequency=100e6, block_len=block_len,
                          module=_MockModule, **kw)


def test_mtu_chunking_and_overflow_carry():
    # numElems=2048, MTU=1000: each block takes 3 reads (1000+1000+48) and
    # carries 952 samples of overflow into the next block — the stream must
    # still be gapless and bit-exact.
    src = _make(block_len=2048)
    it = iter(src)
    blocks = [next(it) for _ in range(5)]
    got = np.concatenate(blocks, axis=-1)
    k = np.arange(got.shape[-1])
    np.testing.assert_array_equal(got[0], (k / 1e6).astype(np.float32))
    np.testing.assert_array_equal(got[1], (-k / 1e6).astype(np.float32))
    assert all(b.shape == (2, 2048) for b in blocks)


def test_rate_renegotiation_updates_block_sizing():
    # Device forces 0.5x the requested rate: the source must adopt the
    # APPLIED rate (ref :499-513) and size blocks off it.
    class _Dev(_MockDevice):
        def __init__(self, args):
            super().__init__(args)
            self.applied_rate_factor = 0.5

    class _Mod(_MockModule):
        Device = _Dev

    src = SoapySDRSource("", sample_rate=2_400_000, module=_Mod)
    assert src.sample_rate == 1_200_000
    assert src.num_elems == optimal_element_count(1_200_000)


def test_staged_settings_apply_between_reads():
    src = _make()
    dev = src.device
    n0 = len(dev.calls)
    src.set_frequency(101e6)
    src.set_gain("LNA", 32.0)
    src.set_agc(False)
    src.write_setting("biastee", "true")
    assert len(dev.calls) == n0          # staged, NOT applied yet
    next(iter(src))                      # one read -> settings drain first
    tail = dev.calls[n0:]
    assert ("freq", "RF", 101e6) in tail
    assert ("gain", "LNA", 32.0) in tail
    assert ("agc", False) in tail
    assert ("setting", "biastee", "true") in tail


def test_device_loss_raises_and_runner_surfaces_it():
    src = _make()
    src.device.fail_after_reads = 4
    it = iter(src)
    with pytest.raises(DeviceLostError):
        for _ in range(100):
            next(it)

    # Through LiveReceiver: the producer thread must die cleanly and set
    # source_error instead of crashing the process.
    from cubicsdr.app.runner import LiveReceiver
    from cubicsdr.ops.planar import PLANAR
    from cubicsdr.receiver import (
        DemodulatorMgr, ReceiverPipeline, plan_from_manager,
        controls_from_manager)
    fs = 2_400_000
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 200e3, "FM", 200000)
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(fs, specs, dtype=PLANAR)
    controls = controls_from_manager(mgr, rx, keyed, 100e6)
    src2 = _make(block_len=rx.block_len)
    src2.device.fail_after_reads = 3
    lr = LiveReceiver(rx, controls, src2, waterfall_fft=256,
                      waterfall_lines=8)
    lr.start_producer()
    lr._producer.join(timeout=10)
    assert not lr._producer.is_alive()
    assert isinstance(lr.source_error, DeviceLostError)
    lr.stop()


def test_blocking_read_yields_partial_then_continues():
    src = _make(block_len=2048)
    src.device.block_after_reads = 2     # 2000 samples then a stall
    it = iter(src)
    blk = next(it)
    assert blk.shape == (2, 2000)        # partial block, not a hang


def test_stop_then_restart_streams_again():
    """Round-3 advisor (medium): stop() latched the source dead forever —
    a device-picker stop -> start left a producer that exited instantly.
    A fresh iteration clears the latch (restart path)."""
    src = _make(block_len=2_048)
    it = iter(src)
    b0 = next(it)
    assert b0.shape == (2, 2_048)
    src.stop()
    # The stopped iteration ends (drops any truncated tail).
    assert list(it) == []
    # A NEW iteration streams again — continuing the device sample counter.
    it2 = iter(src)
    b1 = next(it2)
    assert b1.shape == (2, 2_048)
    assert b1[0, 0] > b0[0, -1]          # stream continued, not reset
    src.restart()                        # explicit re-arm is also fine
    assert next(iter(src)).shape == (2, 2_048)
