"""LiveReceiver — the running application core.

The analog of CubicSDR::OnInit's thread/queue wiring (ref: src/CubicSDR.cpp:
342-397) as an array program: ONE producer thread fills the native
sample ring from a source (file/synthetic/socket), and the consumer loop
pops fixed blocks, runs the compiled receiver step, and fans results out to
audio sinks (per-demod recorders + mix), the spectrum/waterfall processors,
and the metrics registry. Back-pressure = the bounded ring's try-push
shedding, exactly the reference's queue-full policy
(ref: src/sdr/SoapySDRThread.cpp:384-399).

Representation: when the pipeline is planar (dtype=PLANAR — the app path),
the ring's (re, im) planes feed the compiled step directly as a PC pair and
the visual chain (distributor re-block + spectrum EMA) is ONE jitted planar
program per block — no complex64 ever reaches the device, and no per-op
eager dispatch. complex64 pipelines (CPU tests) take the same code path
with complex arrays.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional

import numpy as np

from cubicsdr.io.recorder import RecordingSink, SquelchOption
from cubicsdr.native import SampleRing
from cubicsdr.ops.planar import PC, PLANAR
from cubicsdr.utils.metrics import Metrics
from cubicsdr.visual import (FFTDataDistributor, PlanarSpectrumProcessor,
                             SpectrumProcessor, Waterfall)


class _Stager:
    """Single DAEMON worker running staged host->device puts.

    A ThreadPoolExecutor's non-daemon workers are joined at interpreter
    exit: one put hung on a dead transport would hang process shutdown.
    The reference force-exits when termination stalls for this exact
    reason (ref: src/CubicSDR.cpp:448-490 ::exit(11)); a daemon thread
    dies with the process instead."""

    class _Box:
        def __init__(self):
            self._ev = threading.Event()
            self._val = None
            self._exc = None

        def result(self):
            self._ev.wait()
            if self._exc is not None:
                raise self._exc
            return self._val

    def __init__(self, name: str = "cs-stage"):
        import queue
        self._q: "queue.Queue" = queue.Queue()
        self._t = threading.Thread(target=self._run, name=name,
                                   daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, box = item
            try:
                box._val = fn(*args)
            except BaseException as e:       # noqa: BLE001 — re-raised
                box._exc = e
            finally:
                box._ev.set()

    def submit(self, fn, *args) -> "_Stager._Box":
        box = self._Box()
        self._q.put((fn, args, box))
        return box

    def shutdown(self):
        self._q.put(None)


class LiveReceiver:
    def __init__(self, pipeline, controls, source,
                 center_freq: float = 0.0,
                 ring_seconds: float = 2.0,
                 record_path: Optional[str] = None,
                 record_squelch: SquelchOption = SquelchOption.RECORD_SILENCE,
                 record_time_limit: float = 0.0,
                 waterfall_fft: int = 1024,
                 waterfall_lines: int = 256,
                 waterfall_lps: float = 30.0,
                 on_block: Optional[Callable] = None,
                 ingest_dtype=None, ingest_scale: Optional[float] = None):
        import jax
        import jax.numpy as jnp
        self._jnp = jnp
        self.pipeline = pipeline
        self.planar = getattr(pipeline, "dtype", None) == PLANAR
        self.controls = controls
        self.source = source
        self.center_freq = center_freq
        # Native-format ingest: the ring/host->device path carries the
        # WIRE sample format (cs16/cs8 planes — what real SDR hardware
        # emits) and the compiled step converts on the device's vector
        # units. Halves/quarters the bytes through host memory and DMA vs
        # the reference's host-side CF32 conversion
        # (ref: src/sdr/SoapySDRThread.cpp:253-343).
        self.ingest_dtype = np.dtype(ingest_dtype or np.float32)
        if self.ingest_dtype != np.float32 and not self.planar:
            raise ValueError("raw-format ingest requires a planar pipeline")
        if ingest_scale is None:
            ingest_scale = {2: 1.0 / 32768.0, 1: 1.0 / 128.0}.get(
                self.ingest_dtype.itemsize, 1.0)
        self.ingest_scale = float(ingest_scale)
        # Compiled-program caches: plan swaps that return to a previously
        # seen pipeline (the control plane caches pipeline objects by plan
        # signature) must NOT recompile — a cold step compile stalls the
        # consumer, which would starve the ring during live churn. Keyed by pipeline identity (weak: dropping a plan frees
        # its programs).
        import weakref
        self._step_cache = weakref.WeakKeyDictionary()
        self._post_cache: dict = {}
        # Donate the streaming state: the live loop's state buffers recycle
        # in place instead of allocating per block (the ReBuffer recycling
        # role on-device, ref: src/IOThread.h:46-155).
        self.step = self._make_step(pipeline)
        self.state = pipeline.init_state()
        self.metrics = Metrics()
        self._ring_seconds = float(ring_seconds)
        cap = int(pipeline.sample_rate * ring_seconds)
        self.ring = SampleRing(max(cap, 4 * pipeline.block_len),
                               dtype=self.ingest_dtype)
        self.record_path = record_path
        self._recorders: dict[int, RecordingSink] = {}
        self._rec_opts = (record_squelch, record_time_limit)
        # Per-demod runtime recording control (ref: DemodulatorInstance::
        # startRecording/stopRecording, src/demod/DemodulatorInstance.cpp:
        # 600-655): launching with record_path records every analog demod
        # (record_all); REST toggles override per flat row index.
        self.record_all = record_path is not None
        self.rec_override: dict = {}
        # Stable per-row identities (set by the control plane to demod
        # instance ids): recorders and recording flags key on these, so a
        # plan rebuild that shifts flat row indices never redirects a
        # demod's audio into another demod's WAV. None -> flat indices.
        self.row_keys: Optional[list] = None
        self.on_block = on_block

        dt = PLANAR if self.planar else jnp.complex64
        self.dist = FFTDataDistributor(
            waterfall_fft * 2, pipeline.sample_rate,
            lines_per_second=waterfall_lps, block_len=pipeline.block_len,
            dtype=dt)
        spec_cls = PlanarSpectrumProcessor if self.planar \
            else SpectrumProcessor
        self.spec = spec_cls(waterfall_fft)
        self.waterfall = Waterfall(waterfall_fft, waterfall_lines)
        self._st_dist = self.dist.init_state()
        self._st_spec = self.spec.init_state()

        # Demod-view spectrum (the second SpectrumVisualProcessor instance,
        # ref: src/CubicSDR.cpp:340,374): tracks ONE selected demod's IQ
        # tap. FUSED into the packed post-step — the selected row's tap is
        # re-blocked + FFT'd on device and its display points ride the one
        # packed pull, so selecting a demod costs no extra D2H round-trip.
        self.demod_view: Optional[int] = None    # flat (group-order) index
        self.demod_view_fft = 256
        self.demod_spectrum: Optional[np.ndarray] = None
        self._spec_cls = spec_cls
        self._dv_gi: Optional[int] = None        # group of the viewed row
        self._dv_off = 0                         # flat offset of that group
        self._dv_dist = None
        self._dv_spec = None
        self._st_dv: tuple = ()

        self._install_post()

        # Live audio tap: rolling mix chunks for HTTP/host audio sinks (the
        # AudioThread output analog, ref: src/audio/AudioThread.cpp:88-243).
        self.audio_tap: collections.deque = collections.deque(maxlen=64)
        self.audio_cond = threading.Condition()
        self._audio_seq = 0
        # Host audio playback (RtAudio role): N named sinks, each fed
        # the full mix, one soloed demod, or a HOST-MIXED demod subset —
        # the reference's per-device controller mixing where every demod
        # picks its own output device (ref: src/audio/AudioThread.cpp:
        # 370-442 bound threads + audioCallback mixing :88-243). The
        # "default" sink is the legacy single-output surface.
        self.audio_sinks: dict[str, dict] = {}
        self.audio_solo: Optional[int] = None    # flat demod index | None

        # Zoomed main-spectrum view (the is_view SpectrumVisualProcessor,
        # ref: src/process/SpectrumVisualProcessor.cpp:283-386) with
        # retune/zoom display continuity. Created lazily by set_zoom();
        # zoom-off stashes the view (compiled levels are expensive).
        self.zoom = None
        self._zoom_stash = None

        self._stop = threading.Event()
        self._stage_pool = None          # lazy 1-thread H2D staging worker
        self._staged = None              # in-flight staged-block future
        self._producer: Optional[threading.Thread] = None
        self._producer_gen = 0               # bumped to retire a producer
        self.source_error: Optional[Exception] = None
        # Serializes step dispatch/state reassignment against control-plane
        # threads (plan swap, state snapshot): with donated state buffers,
        # reading ``self.state`` concurrently with an in-flight step would
        # touch a dead buffer. Held only for the (async) dispatch — never
        # for device compute or host fanout.
        self.step_lock = threading.Lock()

    # --- producer: source -> ring (the SDRThread readLoop analog) ---
    def _produce(self, source, gen: int):
        from cubicsdr.io.soapy import DeviceLostError
        try:
            for blk in source:
                if self._stop.is_set() or gen != self._producer_gen:
                    break
                blk = np.asarray(blk)
                if blk.ndim == 2 and blk.shape[0] == 2:
                    re, im = blk[0], blk[1]      # planar source (soapy)
                else:
                    re, im = blk.real, blk.imag
                n = re.shape[-1]
                dt = self.ingest_dtype
                if dt != np.float32 and re.dtype != dt:
                    if re.dtype.kind == "i":
                        # Raw->raw width change (cs8 source, cs16 ring):
                        # rescale between integer full scales.
                        k = float(np.iinfo(dt).max + 1) \
                            / float(np.iinfo(re.dtype).max + 1)
                    else:
                        # Float source into a raw-format ring: quantize at
                        # the inverse of the device-side scale (sources
                        # are within ±1 full scale).
                        k = 1.0 / self.ingest_scale
                    re = np.clip(np.asarray(re, np.float32) * k,
                                 np.iinfo(dt).min, np.iinfo(dt).max)
                    im = np.clip(np.asarray(im, np.float32) * k,
                                 np.iinfo(dt).min, np.iinfo(dt).max)
                elif dt == np.float32 and re.dtype.kind == "i":
                    # Raw-format source (CS16/CS8 stream) into an f32
                    # ring: normalize to ±1 — a bare int->float cast would
                    # be 32768x/128x hot.
                    k = 1.0 / float(np.iinfo(re.dtype).max + 1)
                    re = np.asarray(re, np.float32) * k
                    im = np.asarray(im, np.float32) * k
                ok = self.ring.write(np.ascontiguousarray(re, dt),
                                     np.ascontiguousarray(im, dt))
                self.metrics.tick("ingest", n, dropped=0 if ok else n)
                # Surface the live source's loss counters
                # (ref: SoapySDRThread overflow warnings, :384-399).
                ov = getattr(source, "overflow_events", 0)
                if ov:
                    self.metrics.note("source_overflow_events", ov)
                sb = getattr(source, "short_blocks", 0)
                if sb:
                    self.metrics.note("source_short_blocks", sb)
        except DeviceLostError as e:
            # Device vanished: stop producing, surface to the app loop
            # (ref: SoapySDRThread.cpp:405-433 device-loss stop + notify).
            self.source_error = e

    def start_producer(self):
        self._producer = threading.Thread(
            target=self._produce, args=(self.source, self._producer_gen),
            daemon=True)
        self._producer.start()

    def stop_producer(self, timeout: float = 2.0):
        """Retire the current producer thread without stopping the app."""
        self._producer_gen += 1
        if hasattr(self.source, "stop"):
            try:
                self.source.stop()           # unblock a waiting read
            except Exception:                # noqa: BLE001
                pass
        if self._producer is not None:
            self._producer.join(timeout=timeout)
            self._producer = None

    def set_source(self, source, close_old: bool = True):
        """Swap the live source between blocks (the reference's
        CubicSDR::setDevice device swap, ref: src/CubicSDR.cpp:797-855):
        retire the old read thread, optionally close the old device, point
        at the new source and start reading."""
        was_running = self._producer is not None
        self.stop_producer()
        old = self.source
        if close_old and old is not None and old is not source:
            for m in ("close",):
                try:
                    getattr(old, m, lambda: None)()
                except Exception:            # noqa: BLE001
                    pass
        self.source = source
        self.source_error = None
        if was_running:
            self.start_producer()

    def _make_step(self, pipeline):
        """The compiled per-block step. For raw-format ingest, wire planes
        convert to f32 ON DEVICE (a fused multiply) and the converted
        full-band iq replaces the passthrough tap so the visual chain sees
        f32. Cached per pipeline object: swapping back to a cached plan
        reuses its compiled program."""
        import jax
        jnp = self._jnp
        step = self._step_cache.get(pipeline)
        if step is not None:
            return step
        if self.ingest_dtype == np.float32:
            step = jax.jit(pipeline.apply, donate_argnums=(0,))
        else:
            scale = self.ingest_scale

            def _step(state, inputs):
                (re_raw, im_raw), controls = inputs
                iq = PC(re_raw.astype(jnp.float32) * scale,
                        im_raw.astype(jnp.float32) * scale)
                state, out = pipeline.apply(state, (iq, controls))
                return state, dict(out, iq=iq)

            step = jax.jit(_step, donate_argnums=(0,))
        self._step_cache[pipeline] = step
        return step

    def snapshot_state(self) -> object:
        """Host (numpy) copy of the streaming state, safe to read from any
        thread: taken under the step lock so it can never alias a buffer
        the donated in-flight step is about to consume. Checkpointing and
        plan-rebuild carry go through this."""
        import jax
        with self.step_lock:
            return jax.tree.map(np.asarray, self.state)

    def swap_pipeline(self, pipeline, controls, state=None,
                      row_keys=None):
        """Install a new compiled plan. When the wideband format changed
        (sample rate / block size / audio rate) the ring and visual chain
        are rebuilt too; otherwise display continuity is preserved.
        ``row_keys`` installs the new rows' stable identities atomically
        with the plan (a dispatch must never pair new keys with old
        rows or vice versa)."""
        import jax
        jnp = self._jnp
        format_changed = (
            pipeline.sample_rate != self.pipeline.sample_rate
            or pipeline.block_len != self.pipeline.block_len
            or pipeline.audio_rate != self.pipeline.audio_rate)
        with self.step_lock:        # never mid-dispatch on the consumer
            self.pipeline = pipeline
            self.controls = controls
            self.step = self._make_step(pipeline)
            self.state = (state if state is not None
                          else pipeline.init_state())
            if row_keys is not None:
                self.row_keys = list(row_keys)
            self.planar = getattr(pipeline, "dtype", None) == PLANAR
            # Flat indices (and group tap shapes) change with the plan:
            # drop the demod view atomically with the swap.
            self._set_demod_view_locked(None)
            if not format_changed:
                return
            # Format change: ring / visual chain / packed post-step are
            # consumed inside the consumer's locked dispatch section, so
            # they must be replaced UNDER the same lock — otherwise the
            # consumer could dispatch a new-block_len block through the
            # old distributor/post program and crash the live loop.
            cap = int(pipeline.sample_rate * self._ring_seconds)
            self.ring = SampleRing(max(cap, 4 * pipeline.block_len),
                                   dtype=self.ingest_dtype)
            dt = PLANAR if self.planar else jnp.complex64
            self.dist = FFTDataDistributor(
                self.spec.fft_size * 2, pipeline.sample_rate,
                lines_per_second=self.dist.lps,
                block_len=pipeline.block_len, dtype=dt)
            self._st_dist = self.dist.init_state()
            self._st_spec = self.spec.init_state()
            self._install_post()
            self.zoom = self._zoom_stash = None   # view rates changed

    # --- consumer: ring -> compiled step -> sinks ---
    def _stage_block(self, L: int):
        """Read one block from the ring and start its host->device
        transfer. Runs on the staging worker so the put of block i+1
        overlaps block i's packed device->host pull (double-buffered H2D;
        on a synchronous transport the put blocks HERE, not on the
        consumer). Returns (iq_device, host_planes, L) or None."""
        jnp = self._jnp
        got = self.ring.read(L)
        if got is None:
            return None
        re, im = got
        if self.ingest_dtype != np.float32:
            # Raw wire planes: converted on-device by the step.
            iq = (jnp.asarray(re), jnp.asarray(im))
        elif self.planar:
            iq = PC(jnp.asarray(re), jnp.asarray(im))
        else:
            iq = jnp.asarray(re) + 1j * jnp.asarray(im)
        return iq, (re, im), L

    def run_blocks(self, max_blocks: Optional[int] = None,
                   wait: bool = True) -> int:
        """Consume ring blocks through the compiled step with ONE block of
        dispatch lookahead: block i's step is enqueued (async under XLA),
        then block i-1's host fanout (waterfall lines, audio tap/sinks,
        recorders — the parts that force device->host pulls) runs while
        the device computes block i. Block i+1's host->device put is
        staged on a worker thread during that same window, so on a
        transport-bound link the wire carries the next block while the
        consumer waits on the current block's packed pull. Host-side
        work, H2D transfer and device compute overlap instead of strictly
        alternating, like the reference's producer/consumer thread overlap (ref: src/sdr/SDRPostThread.cpp:152-199
        pop-while-upstream-reads)."""
        pool = self._stage_pool
        if pool is None:
            pool = self._stage_pool = _Stager()
        n = 0
        pending = None                  # (iq, out, planes) awaiting fanout
        while not self._stop.is_set():
            if max_blocks is not None and n >= max_blocks:
                break
            L = self.pipeline.block_len
            if self._staged is None:
                self._staged = pool.submit(self._stage_block, L)
            blk = self._staged.result()
            self._staged = None
            if blk is not None and blk[2] != self.pipeline.block_len:
                # A plan swap changed the block format between staging
                # and dispatch: the staged samples belong to the old
                # format and are dropped (format swaps rebuild the ring
                # anyway).
                self.metrics.tick("pipeline", 0, dropped=blk[2])
                blk = None
            dispatched = None
            if blk is not None:
                iq, planes, Lb = blk
                with self.step_lock:
                    # Size and representation re-checked UNDER the lock:
                    # a format swap can land between the unlocked
                    # pre-check and here (a planar<->complex swap would
                    # otherwise feed the new step a stale-repr block).
                    ok_repr = (self.ingest_dtype != np.float32
                               or isinstance(iq, PC) == self.planar)
                    if Lb != self.pipeline.block_len or not ok_repr:
                        self.metrics.tick("pipeline", 0, dropped=Lb)
                        blk = None
                    else:
                        self.state, out = self.step(self.state,
                                                    (iq, self.controls))
                        # The packed post-step rides the device queue
                        # right behind its own step; only the host PULL
                        # is deferred one block (_fanout_finish below).
                        disp = self._fanout_dispatch(iq, out)
                    L2 = self.pipeline.block_len
                if blk is not None:
                    self.metrics.tick("pipeline", L)
                    n += 1
                    dispatched = (disp, iq, out, planes)
                # Stage block n+1 while block n computes and block n-1's
                # fanout pulls. The staged future persists on self so a
                # bounded run_blocks call hands its lookahead block to
                # the next call instead of dropping those samples.
                self._staged = pool.submit(self._stage_block, L2)
            if dispatched is None:
                if pending is not None:     # starved: drain the lookahead
                    self._fanout_finish(*pending)
                    pending = None
                if not wait or (self._producer is not None
                                and not self._producer.is_alive()):
                    # A stage that raced the producer's final writes may
                    # have returned empty while blocks remain: drain the
                    # ring before concluding the stream is over.
                    if self.ring.fill >= self.pipeline.block_len:
                        continue
                    break
                self._stop.wait(0.001)
                continue
            if pending is not None:
                self._fanout_finish(*pending)   # overlaps n's compute
            pending = dispatched
        if pending is not None:
            self._fanout_finish(*pending)
        return n

    def set_zoom(self, offset: Optional[float], bandwidth: float = 0.0):
        """Point the zoomed spectrum view at ``offset`` Hz (relative to the
        device center) with ``bandwidth`` Hz span; None disables. View
        moves preserve the smoothed display (pan/rescale, not reset)."""
        if offset is None:
            with self.step_lock:
                # Stash, don't discard: the view carries per-level
                # compiled programs — zoom-off/zoom-on churn must
                # reattach them instead of compiling again.
                if self.zoom is not None:
                    self._zoom_stash = self.zoom
                self.zoom = None
            return
        if bandwidth and not (float(bandwidth) > 0.0):
            # Validate BEFORE lazily creating the view so a bad request
            # can't leave a half-configured zoom active.
            raise ValueError(f"zoom bandwidth must be > 0, got {bandwidth}")
        z = self.zoom
        if z is None and self._zoom_stash is not None \
                and self._zoom_stash.input_rate == self.pipeline.sample_rate \
                and self._zoom_stash.block_len == self.pipeline.block_len \
                and self._zoom_stash.fft_size == self.spec.fft_size:
            z = self._zoom_stash
        if z is None:
            from cubicsdr.visual.spectrum import ZoomSpectrumView
            z = ZoomSpectrumView(
                self.pipeline.sample_rate, self.pipeline.block_len,
                fft_size=self.spec.fft_size,
                dtype=PLANAR if self.planar else self._jnp.complex64)
        # Compile the target level BEFORE attaching/switching: the
        # consumer feeds the view inside its locked dispatch, where a
        # cold compile would stall streaming and the control plane.
        z.prewarm_level(float(bandwidth) or z.view_bandwidth)
        with self.step_lock:
            # View state must never change mid-feed (the device-resident
            # feed runs under this lock on the consumer).
            if self.zoom is None:
                self.zoom = z
            z = self.zoom
            prev_bw = z.resample_bw
            z.set_view(float(offset),
                       float(bandwidth) or z.view_bandwidth)
        if z.resample_bw != prev_bw:
            # Background-compile the one-step-away zoom levels so the next
            # wheel click reuses a warm program.
            z.prewarm_adjacent()

    def set_display(self, lps=None, fft_average_rate=None, peak_hold=None,
                    demod_view_fft=None):
        """Runtime display parameters (ref: AppFrame per-canvas FFT size /
        averaging speed / lines-per-second menus, src/AppFrame.cpp:
        2320-2352): rebuilds only the affected visual programs, carrying
        the smoothed display state so the waterfall never blanks. The
        swap happens under the step lock: the consumer dispatches the
        (donating) packed post-step inside its locked section, so a
        half-replaced visual chain must never be observable there."""
        jnp = self._jnp
        dt = PLANAR if self.planar else jnp.complex64
        with self.step_lock:
            rebuild = False
            if lps is not None and float(lps) != self.dist.lps:
                self.dist = FFTDataDistributor(
                    self.spec.fft_size * 2, self.pipeline.sample_rate,
                    lines_per_second=float(lps),
                    block_len=self.pipeline.block_len, dtype=dt)
                # Same state shapes (history + pacer phase): continuity.
                rebuild = True
            core = getattr(self.spec, "core", self.spec)
            if ((fft_average_rate is not None
                 and float(fft_average_rate) != core.rate)
                    or (peak_hold is not None
                        and bool(peak_hold) != core.peak_hold)):
                spec_cls = type(self.spec)
                self.spec = spec_cls(
                    self.spec.fft_size,
                    float(fft_average_rate) if fft_average_rate is not None
                    else core.rate,
                    peak_hold=bool(peak_hold) if peak_hold is not None
                    else core.peak_hold)
                rebuild = True
            if demod_view_fft is not None \
                    and int(demod_view_fft) != self.demod_view_fft:
                self.demod_view_fft = int(demod_view_fft)
                self.demod_spectrum = None
                if self._dv_gi is not None:
                    # Rebuild the fused dv program at the new FFT size
                    # (state shapes change with it).
                    idx = self.demod_view
                    self.demod_view = None       # force a full rebuild
                    self._set_demod_view_locked(idx)
            if rebuild:
                self._install_post()

    def display_params(self) -> dict:
        core = getattr(self.spec, "core", self.spec)
        return {"lps": self.dist.lps, "fft_average_rate": core.rate,
                "peak_hold": bool(core.peak_hold),
                "fft_size": self.spec.fft_size,
                "demod_view_fft": self.demod_view_fft}

    @property
    def audio_output(self):
        """The 'default' sink's output (legacy single-output surface)."""
        s = self.audio_sinks.get("default")
        return s["output"] if s else None

    def set_audio_output(self, backend, device=None, rate=None):
        """Attach/replace/detach the default host playback sink.
        backend: AudioOutput | 'auto' | 'sounddevice' | 'wav:<path>' |
        'null' | None (detach)."""
        self.set_audio_sink("default", backend, device, rate=rate)

    def set_audio_sink(self, name: str, backend=None, device=None,
                       demods: Optional[list] = None,
                       rate: Optional[int] = None):
        """Configure one of N named host output sinks (the reference's
        per-demod output-device routing: several devices run at once,
        each mixing its bound demods, ref: src/audio/AudioThread.cpp:
        370-442). ``demods`` = STABLE row keys (instance ids when the
        control plane registered row_keys, else flat row indices) mixed
        host-side for this sink — key-addressed so a plan rebuild that
        reorders rows never redirects another demod's audio into this
        sink. None = the device-mixed full mix. backend None removes.
        ``rate``: the sink device's OWN sample rate — audio is resampled
        host-side from the pipeline rate (the reference's per-device
        negotiated rate + runtime switch, ref: src/audio/AudioThread
        .cpp:493-506)."""
        from cubicsdr.io.audio_out import AudioOutput, HostResampler
        old = self.audio_sinks.pop(name, None)
        if old is not None:
            old["output"].close()
        if backend is None:
            return
        pipe_rate = int(self.pipeline.audio_rate)
        rate = int(rate) if rate else pipe_rate
        if not isinstance(backend, AudioOutput):
            backend = AudioOutput(rate, 2, backend=str(backend),
                                  device=device)
        self.audio_sinks[name] = {
            "output": backend,
            "resampler": (None if rate == pipe_rate
                          else HostResampler(pipe_rate, rate)),
            "demods": None if demods is None else list(demods)}

    def set_audio_solo(self, key):
        """Route ONE demod (stable row key — see set_audio_sink) to the
        host device instead of the mix (the reference's per-demod
        output-device routing, ref: AudioThread per-device bound
        threads). None restores the mix."""
        self.audio_solo = key

    def _subset_mix(self, hgroups, demods, keys, ctls
                    ) -> Optional[np.ndarray]:
        """Host-side mix of a demod subset for one sink: gain-weighted
        active rows summed, peak-normalized above 1.0 — the per-device
        mixing math of the reference's audioCallback
        (ref: src/audio/AudioThread.cpp:174-240). ``keys``/``ctls`` are
        the DISPATCH-time row identities and (gain, active) snapshots of
        this block: a plan swap between dispatch and this deferred finish
        must neither shift rows nor index fresh control arrays."""
        sel = set(demods)
        acc, off = None, 0
        for gi, h in enumerate(hgroups):
            rows = h["level"].shape[0]
            if "audio" not in h:
                off += rows
                continue
            gain, active = ctls[gi]
            for pos, ri in enumerate(h["audio_rows"]):
                if keys[off + ri] in sel and bool(active[ri]):
                    a = h["audio"][pos] * float(gain[ri])
                    if a.shape[0] == 1:
                        a = np.concatenate([a, a])
                    acc = a.copy() if acc is None else acc + a
            off += rows
        if acc is None:
            return None
        peak = float(np.abs(acc).max())
        if peak > 1.0:
            acc = acc / peak
        return acc

    def _solo_audio(self, hgroups, keys) -> Optional[np.ndarray]:
        """One demod's audio from the packed host groups (no extra pull),
        located by its stable row key."""
        solo, off = self.audio_solo, 0
        for h in hgroups:
            rows = h["level"].shape[0]
            for ri in range(rows):
                if keys[off + ri] == solo:
                    if "audio" not in h or ri not in h["audio_rows"]:
                        return None          # digital / not packed
                    a = h["audio"][h["audio_rows"].index(ri)]
                    return (np.concatenate([a, a]) if a.shape[0] == 1
                            else a)
            off += rows
        return None

    def set_demod_view(self, idx: Optional[int]):
        """Select which demod's IQ tap feeds the demod-view spectrum
        (flat group-order index; None disables). The view is computed
        in-graph by the packed post-step (rebuilt here), so it adds no
        per-block device round-trip."""
        with self.step_lock:
            self._set_demod_view_locked(idx)

    def _set_demod_view_locked(self, idx: Optional[int]):
        if idx == self.demod_view and (idx is None
                                       or self._dv_gi is not None):
            return
        self.demod_view = idx
        self.demod_spectrum = None
        self._dv_gi, self._dv_off = None, 0
        if idx is not None:
            off = 0
            for gi, g in enumerate(getattr(self.pipeline, "groups", ())):
                if idx < off + g.count:
                    self._dv_gi, self._dv_off = gi, off
                    break
                off += g.count
        self._install_post()

    def _install_post(self):
        """(Re)install the packed post-step for the current (pipeline,
        visual chain, demod view) combination, reusing a previously
        compiled program when the combination was seen before — view
        toggles and plan-cache swaps must not pay a fresh trace/compile."""
        dv_on = self._dv_gi is not None
        core = getattr(self.spec, "core", self.spec)
        # VALUE-keyed: display toggles (lps 20<->30, averaging, peak
        # hold) rebuild dist/spec objects with previously-seen params —
        # id-keyed caching missed on every toggle and recompiled the
        # packed post-step each time (a stream stall per REST op). The
        # program is fully determined by these parameters
        # because _make_post BINDS its dist/spec objects at creation.
        key = (id(self.pipeline), self.spec.fft_size, core.rate,
               bool(core.peak_hold), self.dist.lps, self.dist.fft_size,
               self.dist.block_len, self.dist.sample_rate,
               self._dv_gi, self.demod_view_fft if dv_on else None)
        hit = self._post_cache.get(key)
        if hit is not None:
            self._post, self._dv_dist, self._dv_spec = hit[:3]
        else:
            if dv_on:
                # Re-block the selected row's bandwidth-rate tap to the
                # view FFT size on device (the demod-view
                # SpectrumVisualProcessor chain, ref: src/CubicSDR.cpp:
                # 340,374). Fresh distributor: its block_len latches to
                # the tap length at first trace.
                rate = float(
                    self.pipeline.frontends[self._dv_gi].bandwidth)
                dt = PLANAR if self.planar else self._jnp.complex64
                self._dv_dist = FFTDataDistributor(
                    self.demod_view_fft * 2, rate,
                    lines_per_second=self.dist.lps, dtype=dt)
                self._dv_spec = self._spec_cls(self.demod_view_fft)
            else:
                self._dv_dist = self._dv_spec = None
            self._post = self._make_post()
            if len(self._post_cache) >= 32:
                self._post_cache.clear()
            # The value pins the pipeline: cache keys are object ids, so
            # every keyed object must stay alive for its entry's lifetime
            # (dist/spec are pinned by the post closure itself).
            self._post_cache[key] = (self._post, self._dv_dist,
                                     self._dv_spec, self.pipeline)
        self._st_dv = ((self._dv_dist.init_state(),
                        self._dv_spec.init_state()) if dv_on else ())

    def _make_post(self):
        """Compile the post-step: the visual chain (distributor re-block +
        spectrum EMA) FUSED with output packing — every host-needed output
        of a block (display points, line count, mix audio, per-demod
        levels, squelch flags, digital symbols, optionally per-demod
        audio) leaves the device as ONE packed f32 vector, i.e. ONE
        device->host transfer per block. Each separate pull pays a fixed
        round-trip latency regardless of size, so per-consumer pulls
        (points, nv scalar, mix, per-group levels/symbols) would add one
        latency each to the live loop's block time."""
        import jax
        jnp = self._jnp
        # Bind the visual-chain objects NOW: the jit traces lazily (at
        # first dispatch), and the value-keyed post cache is only sound
        # if a cached program can never pick up a dist/spec swapped in
        # after its creation.
        dist, spec = self.dist, self.spec
        dv_dist, dv_spec = self._dv_dist, self._dv_spec

        def _post(sts, x, mix, g_parts, dv_tap, dv_row):
            st_dist, st_spec, st_dv = sts
            st_dist, (frames, valid) = dist.apply(st_dist, x)
            st_spec, disp = spec.apply(st_spec, frames, valid=valid)
            parts = [disp["spectrum_points"].ravel(),
                     jnp.sum(valid.astype(jnp.int32))
                        .astype(jnp.float32)[None]]
            if mix is not None:
                parts.append(mix.ravel())
            for gp in g_parts:
                parts.append(gp["level"].ravel())
                for k in ("squelched", "symbols", "audio"):
                    if gp[k] is not None:
                        parts.append(gp[k].astype(jnp.float32).ravel())
            if dv_tap is not None:
                # Demod-view spectrum fused in-graph: the selected row's
                # bandwidth-rate tap (dynamic row index — switching rows
                # within a group reuses the compiled program) re-blocked
                # and EMA'd like the main spectrum, its points riding the
                # same packed pull (ref: the second SpectrumVisualData
                # Thread, src/CubicSDR.cpp:340,374).
                tap = (PC(dv_tap.re[dv_row], dv_tap.im[dv_row])
                       if isinstance(dv_tap, PC) else dv_tap[dv_row])
                st_dvd, st_dvs = st_dv
                st_dvd, (dfr, dval) = dv_dist.apply(st_dvd, tap)
                st_dvs, ddisp = dv_spec.apply(st_dvs, dfr, valid=dval)
                parts.append(ddisp["spectrum_points"].ravel())
                st_dv = (st_dvd, st_dvs)
            return (st_dist, st_spec, st_dv), jnp.concatenate(parts)

        return jax.jit(_post, donate_argnums=(0,))

    def row_key(self, fi: int):
        """Stable identity of flat row ``fi`` (instance id when the
        control plane registered row_keys, else the index itself)."""
        return (self.row_keys[fi]
                if self.row_keys is not None and fi < len(self.row_keys)
                else fi)

    def recording_enabled(self, key) -> bool:
        """Is the row with stable key ``key`` recording right now?"""
        return bool(self.record_path) and self.rec_override.get(
            key, self.record_all)

    def any_recording(self) -> bool:
        return bool(self.record_path) and (
            self.record_all or any(self.rec_override.values()))

    def set_recording(self, key: int, on: bool,
                      path: Optional[str] = None):
        """Attach/detach ONE demod's recording sink at runtime (the 'R'
        hotkey, ref: src/demod/DemodulatorInstance.cpp:600-655). ``key``
        is the flat group-order row index; ``path`` (re)sets the base
        recording path. Stopping closes + finalizes the WAV."""
        if path:
            self.record_path = path
        if on and not self.record_path:
            raise ValueError("no recording path set")
        self.rec_override[key] = bool(on)
        if not on:
            r = self._recorders.pop(key, None)
            if r is not None:
                r.close()

    def set_record_options(self, squelch=None, time_limit=None,
                           path: Optional[str] = None):
        """Runtime recording options (ref: AppFrame recording-options
        menu + AudioSinkFileThread setSquelchOption/setFileTimeLimit,
        src/audio/AudioSinkFileThread.cpp:28-73). Applied to sinks
        created afterwards; existing files keep their policy."""
        sq, tl = self._rec_opts
        if squelch is not None:
            sq = SquelchOption(squelch)
        if time_limit is not None:
            tl = float(time_limit)
        self._rec_opts = (sq, tl)
        if path:
            self.record_path = path

    def _pack_parts(self, out):
        """(mix, g_parts) args for the packed post-step. The structure is
        static per (plan, recording/audio config): toggling recording or
        attaching a host audio output retraces the post-step once.

        Per-demod audio is packed for ONLY the rows the host actually
        needs (active recorders, subset-sink members, the solo target) —
        shipping the whole farm's audio when one demod records would
        put MBs per block back on the wire the packed-pull design
        exists to spare."""
        rec = self.any_recording()
        sink_keys = set()
        for s in self.audio_sinks.values():
            if s["demods"] is not None:
                sink_keys.update(s["demods"])
        if self.audio_solo is not None and "default" in self.audio_sinks:
            sink_keys.add(self.audio_solo)
        g_parts = []
        off = 0
        for g in out.get("groups", ()):
            n = g["level"].shape[0]
            has_audio = "audio" in g
            rows = []
            if has_audio and (rec or sink_keys):
                for ri in range(n):
                    key = self.row_key(off + ri)
                    if ((rec and self.recording_enabled(key))
                            or key in sink_keys):
                        rows.append(ri)
            g_parts.append({
                "level": g["level"],
                "squelched": (g["squelched"]
                              if rec and has_audio else None),
                "symbols": g.get("symbols"),
                "audio": (g["audio"][np.asarray(rows)]
                          if rows else None),
                "audio_rows": tuple(rows),
            })
            off += n
        return out.get("mix"), g_parts

    def _fanout_dispatch(self, iq, out):
        """Enqueue the packed post-step right behind its own block's step
        (device queue order matters: dispatched any later, its result
        would wait behind the NEXT block's compute). Returns the pending
        device handle for _fanout_finish."""
        mix_dev, g_parts = self._pack_parts(out)
        dv_tap = dv_row = None
        dv_n = 0
        if self._dv_gi is not None and self._dv_gi < len(out["groups"]):
            dv_tap = out["groups"][self._dv_gi]["iq"]
            dv_row = np.int32(self.demod_view - self._dv_off)
            dv_n = self.demod_view_fft
        # The visual chain taps out["iq"] — the (converted-f32) full-band
        # block the compiled step saw.
        (self._st_dist, self._st_spec, self._st_dv), packed = self._post(
            (self._st_dist, self._st_spec, self._st_dv),
            out["iq"], mix_dev, g_parts, dv_tap, dv_row)
        # Snapshot everything the deferred finish needs AT DISPATCH (we
        # hold the step lock here): the split geometry (spec may be
        # swapped by a plan rebuild before the lookahead finish runs),
        # the row identities of THIS block, and the per-row (gain,
        # active) control values — the finish thread must never index
        # control arrays a concurrent swap may have replaced with
        # fewer/reordered rows.
        n_rows = sum(gp["level"].shape[0] for gp in g_parts)
        keys = [self.row_key(i) for i in range(n_rows)]
        ctls = [(np.array(c["gain"], np.float32),
                 np.array(c["active"], bool)) for c in self.controls]
        # Zoomed view fed from the DEVICE-resident block (no host->device
        # re-upload); its small outputs are pulled by the deferred finish.
        zoom_h = None
        if self.zoom is not None:
            try:
                h = self.zoom.feed_device(out["iq"])
                if h is not None:
                    # Pin the VIEW OBJECT with its handles: a zoom-off
                    # between this dispatch and the deferred finish must
                    # not leave the finish dereferencing self.zoom=None.
                    zoom_h = (self.zoom, *h)
            except Exception as e:           # noqa: BLE001 — advisory view
                self.metrics.note("zoom_error", str(e))
        return (packed, mix_dev, g_parts, self.spec.fft_size, keys, ctls,
                dv_n, zoom_h)

    def _fanout(self, iq, out, planes=None):
        self._fanout_finish(self._fanout_dispatch(iq, out), iq, out, planes)

    def _fanout_finish(self, disp, iq, out, planes=None):
        packed, mix_dev, g_parts, P, keys, ctls, dv_n, zoom_h = disp
        host = np.asarray(packed)            # the ONE device->host pull
        pts = host[:P]
        nv = int(host[P])
        off = P + 1

        def take(shape):
            nonlocal off
            n = int(np.prod(shape))
            v = host[off:off + n].reshape(shape)
            off += n
            return v

        mix = take(mix_dev.shape) if mix_dev is not None else None
        hgroups = []
        for g, gp in zip(out.get("groups", ()), g_parts):
            h = {"level": take(gp["level"].shape)}
            if gp["squelched"] is not None:
                h["squelched"] = take(gp["squelched"].shape) > 0.5
            if gp["symbols"] is not None:
                h["symbols"] = take(gp["symbols"].shape).astype(np.int32)
            if gp["audio"] is not None:
                # Only the host-needed rows were packed; audio_rows maps
                # packed position -> group row index.
                h["audio"] = take(gp["audio"].shape)
                h["audio_rows"] = gp["audio_rows"]
            if "iq" in g:
                h["iq"] = g["iq"]     # device tap: pulled only on demand
            hgroups.append(h)

        if dv_n:
            # Demod-view points computed in-graph, part of the one pull.
            self.demod_spectrum = take((dv_n,)).copy()

        if nv:
            self.waterfall.add_lines(np.tile(pts, (nv, 1)))
        # Zoomed spectrum view: device-fed handles pulled here; host
        # planes only as the chunk-misaligned fallback.
        if zoom_h is not None:
            z, pts_d, nv_d = zoom_h
            if int(nv_d):
                z.points = np.asarray(pts_d)
        elif self.zoom is not None and planes is not None:
            p = np.stack(planes)
            if p.dtype != np.float32:
                p = p.astype(np.float32) * self.ingest_scale
            self.zoom.feed(p)
        # Mix audio tap for live listeners.
        if mix is not None:
            with self.audio_cond:
                self.audio_tap.append(mix)
                self._audio_seq += 1
                self.audio_cond.notify_all()
            for name, sink in list(self.audio_sinks.items()):
                if name == "default" and self.audio_solo is not None:
                    a = self._solo_audio(hgroups, keys)
                elif sink["demods"] is None:
                    a = mix
                else:
                    a = self._subset_mix(hgroups, sink["demods"],
                                         keys, ctls)
                if a is not None:
                    try:
                        rs = sink.get("resampler")
                        if rs is not None:
                            a = rs.process(a)
                        if a.shape[-1]:
                            sink["output"].write(a)
                    except Exception as e:       # noqa: BLE001 — device
                        self.metrics.note(f"audio_out_error_{name}",
                                          str(e))
        # Recording sinks per demod group/row (digital groups emit symbols,
        # not audio — they are skipped but still advance the flat index).
        # Gated on the DISPATCH-time packing (squelched present), not the
        # current recording state: a toggle between dispatch and this
        # deferred finish must not dereference fields that weren't packed.
        gi_off = 0
        for h in hgroups:
            rows = h["level"].shape[0]
            audio, squelched = h.get("audio"), h.get("squelched")
            if audio is None or squelched is None:
                gi_off += rows
                continue
            for pos, ri in enumerate(h["audio_rows"]):
                key = keys[gi_off + ri]
                if not self.recording_enabled(key):
                    continue
                if key not in self._recorders:
                    sq, tl = self._rec_opts
                    self._recorders[key] = RecordingSink(
                        f"{self.record_path}_demod{key}",
                        int(self.pipeline.audio_rate),
                        channels=audio.shape[1],
                        squelch_option=sq, time_limit_s=tl)
                self._recorders[key].write(audio[pos],
                                           bool(squelched[ri]))
            gi_off += rows
        if self.on_block is not None:
            self.on_block({"groups": hgroups, "mix": mix})

    def stop(self):
        self._stop.set()
        if hasattr(self.source, "stop"):
            try:
                # Unblock a producer stuck inside the source (blocked
                # read, back-pressure wait) — the stop event alone is only
                # checked between yields.
                self.source.stop()
            except Exception:                # noqa: BLE001
                pass
        if self._producer is not None:
            self._producer.join(timeout=2.0)
        if self._stage_pool is not None:
            self._stage_pool.shutdown()
            self._stage_pool = self._staged = None
        for r in self._recorders.values():
            r.close()
        for s in self.audio_sinks.values():
            s["output"].close()
        self.audio_sinks.clear()

    def status(self) -> str:
        return self.metrics.status_line()
