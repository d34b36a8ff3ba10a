"""Live SoapySDR hardware source — the SDRThread read loop re-designed as
an iterator feeding the native sample ring.

Reference behavior carried over (ref: src/sdr/SoapySDRThread.cpp):
  * CF32 stream setup + MTU discovery with broken-MTU fallback (:505-527)
  * fixed numElems blocks (~1 display frame) assembled from MTU-sized
    readStream chunks (:195-279)
  * overflow carry — a chunk read past numElems is saved and drained first
    on the next block (:222-242, :310-340)
  * staged setting atomics: rate / frequency / ppm / agc / per-stage gains /
    device settings are set from any thread and APPLIED between reads
    (:447-604 updateSettings); a rate change deactivates + reactivates the
    stream and re-reads the device-applied rate (devices may refuse, :499-513)
  * device-loss detection -> DeviceLostError out of the iterator
    (:405-433 readLoop stop + notify)

Re-design notes: blocks come out as (re, im) PLANES in the stream's
wire format — float32 for CF32, int16/int8 for native CS16/CS8 streams —
so no complex64 is ever materialized on the ingest path and raw formats
ship at wire width all the way to the accelerator (runner ingest_dtype
converts on-device). The SoapySDR python module is an OPTIONAL import;
construct with ``module=`` to inject a mock for tests.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

TARGET_DISPLAY_FPS = 60          # ref: SoapySDRThread.cpp:12

# SoapySDR error codes (Soapy/Errors.h) — mirrored so the mock needs no
# real module.
SOAPY_SDR_TIMEOUT = -1
SOAPY_SDR_STREAM_ERROR = -2
SOAPY_SDR_CORRUPTION = -3
SOAPY_SDR_OVERFLOW = -4
SOAPY_SDR_NOT_SUPPORTED = -5


class DeviceLostError(RuntimeError):
    """The hardware vanished mid-stream (unplug, driver crash)."""


def optimal_element_count(sample_rate: float, fps: int = TARGET_DISPLAY_FPS,
                          align: int = 512) -> int:
    """~1 display frame of samples, aligned (ref: SoapySDRThread.cpp:
    668-677 aligns to 512)."""
    n = int(np.ceil(sample_rate / fps))
    return max(align, (n + align - 1) // align * align)


class SoapySDRSource:
    """Iterator of float32 [2, numElems] (re, im) plane blocks from a live
    SoapySDR device. Thread-safe setters stage changes; they apply between
    reads exactly like the reference's atomics + updateSettings."""

    #: wire_format -> (soapy stream format, numpy plane dtype)
    WIRE_FORMATS = {"cf32": ("CF32", np.float32),
                    "cs16": ("CS16", np.int16),
                    "cs8": ("CS8", np.int8)}

    def __init__(self, device_args: str | dict = "",
                 sample_rate: float = 2_400_000.0,
                 frequency: float = 100e6,
                 block_len: Optional[int] = None,
                 stream_args: Optional[dict] = None,
                 ppm: float = 0.0, agc: bool = True,
                 iq_swap: bool = False, module=None,
                 wire_format: str = "cf32"):
        if module is None:
            try:
                import SoapySDR as module  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "SoapySDR python module not installed; pass module= "
                    "to inject a driver (tests use a mock)") from e
        self._soapy = module
        self._lock = threading.Lock()
        self._stopping = threading.Event()

        # Native-format streaming: keep the hardware's sample format
        # (cs16/cs8) on the wire AND in the emitted planes — conversion
        # happens on the accelerator (runner ingest_dtype), not the host.
        # The reference always converts to CF32 host-side
        # (ref: src/sdr/SoapySDRThread.cpp:63-171 CF32 setup, :253-343).
        fmt, dtype = self.WIRE_FORMATS[wire_format.lower()]
        self.wire_format = wire_format.lower()
        self.plane_dtype = np.dtype(dtype)
        self.device = module.Device(device_args)
        self.stream = self.device.setupStream(
            getattr(module, "SOAPY_SDR_RX", 0), fmt, [],
            stream_args or {})
        if self.stream is None:
            raise RuntimeError("Stream setup failed, stream is null")

        # Staged settings + change flags (the reference's atomics).
        self._rate = float(sample_rate)
        self._freq = float(frequency)
        self._ppm = float(ppm)
        self._agc = bool(agc)
        self._gains: dict[str, float] = {}
        self._settings: dict[str, str] = {}
        self._changed = {"rate": True, "freq": True, "ppm": ppm != 0.0,
                         "agc": True, "gains": False, "settings": False}
        self._block_len_req = block_len

        self.num_elems = 0
        self.mtu_elems = 0
        self._overflow = np.zeros((2, 0), self.plane_dtype)
        self.sample_rate = float(sample_rate)    # device-applied rate
        self.iq_swap = bool(iq_swap)    # ref: SoapySDRThread.cpp:305-343
        # Observability counters surfaced into the app metrics
        # (ref: saturation/drop warnings, SoapySDRThread.cpp:384-399).
        self.overflow_events = 0        # device reported sample loss
        self.short_blocks = 0           # partial final reads (dropped)
        self._apply_settings(first=True)

    # ---- staged control (any thread) -------------------------------------
    def set_sample_rate(self, rate: float):
        with self._lock:
            self._rate = float(rate)
            self._changed["rate"] = True

    def set_frequency(self, freq: float):
        with self._lock:
            self._freq = float(freq)
            self._changed["freq"] = True

    def set_ppm(self, ppm: float):
        with self._lock:
            self._ppm = float(ppm)
            self._changed["ppm"] = True

    def set_agc(self, agc: bool):
        with self._lock:
            self._agc = bool(agc)
            self._changed["agc"] = True

    def set_gain(self, name: str, value: float):
        with self._lock:
            self._gains[name] = float(value)
            self._changed["gains"] = True

    def write_setting(self, key: str, value):
        with self._lock:
            self._settings[key] = str(value)
            self._changed["settings"] = True

    def set_block_len(self, block_len: int):
        """Pin the block size (the app sizes it to the compiled pipeline's
        block_len AFTER rate negotiation — the device's applied rate decides
        the pipeline, then the pipeline decides the read block)."""
        with self._lock:
            self._block_len_req = int(block_len)
        # Safe pre-start or between reads: the read loop snapshots
        # num_elems at block start.
        self.num_elems = int(block_len)

    def stop(self):
        self._stopping.set()

    def restart(self):
        """Re-arm a stopped source so a new iteration streams again (the
        device-picker stop→start verb, ref: CubicSDR::setDevice restart,
        src/CubicSDR.cpp:797-855). The stream stays set up across stop();
        only the stop latch needs clearing."""
        self._stopping.clear()

    # ---- device side (read thread) ----------------------------------------
    def _apply_settings(self, first: bool = False):
        """The updateSettings analog: drain staged changes onto the device
        (ref: SoapySDRThread.cpp:447-604)."""
        with self._lock:
            changed = dict(self._changed)
            for k in self._changed:
                self._changed[k] = False
            rate, freq, ppm = self._rate, self._freq, self._ppm
            agc, gains = self._agc, dict(self._gains)
            settings = dict(self._settings)
        d, RX = self.device, getattr(self._soapy, "SOAPY_SDR_RX", 0)
        if changed["rate"]:
            if not first:
                d.deactivateStream(self.stream)
            d.setSampleRate(RX, 0, rate)
            # The device MAY apply a different rate (ref :499-513).
            applied = float(d.getSampleRate(RX, 0))
            self.sample_rate = applied
            self.num_elems = (self._block_len_req
                              or optimal_element_count(applied))
            mtu = int(d.getStreamMTU(self.stream) or 0)
            self.mtu_elems = mtu or self.num_elems   # broken-MTU fallback
            self._overflow = np.zeros((2, 0), self.plane_dtype)
            d.activateStream(self.stream)
        if changed["freq"]:
            d.setFrequency(RX, 0, "RF", freq)
        if changed["ppm"] and hasattr(d, "setFrequencyCorrection"):
            d.setFrequencyCorrection(RX, 0, ppm)
        if changed["agc"] and getattr(d, "hasGainMode", lambda *a: False)(
                RX, 0):
            d.setGainMode(RX, 0, agc)
        if changed["gains"]:
            for name, v in gains.items():
                d.setGain(RX, 0, name, v)
        if changed["settings"]:
            for k, v in settings.items():
                d.writeSetting(k, v)

    def _read_block(self, live=None) -> np.ndarray:
        """Assemble one [2, num_elems] plane block from MTU chunks with
        overflow carry (ref: SoapySDRThread.cpp:195-345). ``live`` is the
        owning iteration's liveness predicate (see __iter__)."""
        if live is None:
            live = lambda: not self._stopping.is_set()  # noqa: E731
        self._apply_settings()
        n_elems, mtu = self.num_elems, self.mtu_elems
        out = np.empty((2, n_elems), self.plane_dtype)
        n_read = 0
        # 1. drain the previous read's overflow first.
        if self._overflow.shape[-1]:
            take = min(self._overflow.shape[-1], n_elems)
            out[:, :take] = self._overflow[:, :take]
            self._overflow = self._overflow[:, take:]
            n_read = take
        buf = np.empty(2 * mtu, self.plane_dtype)  # interleaved scratch
        while n_read < n_elems and live():
            # 2. always read a full MTU chunk (readStream is MTU-suited and
            # cannot be adapted dynamically, ref :210-216).
            try:
                sr = self.device.readStream(self.stream, [buf], mtu,
                                            timeoutUs=1 << 30)
            except Exception as e:               # driver blew up = loss
                raise DeviceLostError(str(e)) from e
            n = sr.ret if hasattr(sr, "ret") else int(sr)
            if n == SOAPY_SDR_TIMEOUT:
                continue
            if n == SOAPY_SDR_OVERFLOW:
                self.overflow_events += 1
                continue                          # samples dropped; keep on
            if n < 0:
                raise DeviceLostError(f"readStream error {n}")
            if n == 0:
                break                             # blocking read stalled
            planes = buf[: 2 * n].reshape(n, 2).T  # de-interleave
            take = min(n, n_elems - n_read)
            out[:, n_read: n_read + take] = planes[:, :take]
            if take < n:                          # 3. overflow carry
                self._overflow = np.ascontiguousarray(planes[:, take:])
            n_read += take
        if n_read < n_elems:
            out = out[:, :n_read]
        if self.iq_swap:                          # (re, im) -> (im, re)
            out = out[::-1]
        return out

    def __iter__(self):
        # A fresh iteration clears a previous stop() latch so the webview's
        # device stop→start verb resumes streaming. Each iteration binds
        # to a GENERATION: starting a new one retires any older iteration
        # even if its thread is still mid-read when the latch clears (a
        # stop_producer join timeout could otherwise leave two threads
        # calling readStream on the same stream — streams are not
        # thread-safe, ref: SoapySDRThread's single read thread).
        with self._lock:
            self._iter_gen = getattr(self, "_iter_gen", 0) + 1
            mine = self._iter_gen
            self._stopping.clear()

        def live():
            return (self._iter_gen == mine
                    and not self._stopping.is_set())

        while live():
            blk = self._read_block(live)
            if blk.shape[-1] == 0:
                continue
            if blk.shape[-1] < self.num_elems and not live():
                # stop() interrupted the assembly: DROP the truncated tail
                # rather than leak a short final block downstream
                # (ref: SoapySDRThread.cpp:384-399 shed-on-stop policy).
                self.short_blocks += 1
                break
            yield blk

    def close(self):
        self._stopping.set()
        try:
            self.device.deactivateStream(self.stream)
            self.device.closeStream(self.stream)
        except Exception:
            pass
