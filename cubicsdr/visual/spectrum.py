"""Spectrum display processor — hot path #4.

Faithful port of the SpectrumVisualProcessor *math* (ref:
src/process/SpectrumVisualProcessor.cpp:212-640) re-shaped for XLA: the
per-frame FFT + magnitude + smoothing runs as a lax.scan over a batch of
frames (sequential EMAs are the actual semantics — each frame sees the
previous frame's averages), with all per-bin work vectorized.

Pipeline per frame (fftSizeInternal = fft_size * SPECTRUM_VZM(=2),
ref: CubicSDRDefs.h:44-46):
    FFT -> |.| with fftshift -> double EMA (ma/maa at fft_average_rate)
    -> frame ceil/floor -> EMA'd ceil/floor (0.05 twice)
    -> optional peak hold
    -> accumulate fftSizeInternal bins down to fft_size output points
    -> log-normalize into [0,1] against (floor-0.75, ceil+0.25) * scale
    -> optional DC-spike hide (neighbor mirror over +-2 kHz)

View mode (zoomed spectrum): NCO shift to the view center + rational
resample to the view bandwidth before framing — built by ``SpectrumView``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.ops.nco import NCOMixer
from cubicsdr.ops.resample import RationalResampler, design_ratio
from cubicsdr.stream.op import StreamOp

SPECTRUM_VZM = 2                 # ref: src/CubicSDRDefs.h:46
DEFAULT_FFT_SIZE = 2048          # ref: src/CubicSDRDefs.h:44


def frame_update(core: "SpectrumProcessor", st, mag):
    """One frame's EMA/floor-ceil/peak update given the (shifted) magnitude.
    Shared by the complex and planar paths. First frame seeds the averages
    (the reference's NaN self-heal, ref: SpectrumVisualProcessor.cpp:494-499,
    since ma/maa start unset)."""
    primed = st["primed"][..., None]
    ma = jnp.where(primed, st["ma"], mag)
    maa = jnp.where(primed, st["maa"], mag)
    maa = maa + (ma - maa) * core.rate
    ma = ma + (mag - ma) * core.rate
    fr_ceil = jnp.max(maa, axis=-1)
    fr_floor = jnp.min(maa, axis=-1)
    peak = jnp.maximum(st["peak"], maa) if core.peak_hold else st["peak"]

    def ema2(prev_ma, prev_maa, v, primed1):
        pma = jnp.where(primed1, prev_ma, v)
        pmaa = jnp.where(primed1, prev_maa, v)
        pma = pma + (v - pma) * 0.05
        pmaa = pmaa + (pma - pmaa) * 0.05
        return pma, pmaa

    p1 = st["primed"]
    ceil_ma, ceil_maa = ema2(st["ceil_ma"], st["ceil_maa"], fr_ceil, p1)
    floor_ma, floor_maa = ema2(st["floor_ma"], st["floor_maa"], fr_floor, p1)
    ceil_peak = jnp.maximum(st["ceil_peak"], ceil_maa) \
        if core.peak_hold else st["ceil_peak"]
    floor_peak = jnp.minimum(st["floor_peak"], floor_maa) \
        if core.peak_hold else st["floor_peak"]
    return {"ma": ma, "maa": maa, "peak": peak,
            "ceil_ma": ceil_ma, "ceil_maa": ceil_maa,
            "floor_ma": floor_ma, "floor_maa": floor_maa,
            "ceil_peak": ceil_peak, "floor_peak": floor_peak,
            "primed": jnp.ones_like(st["primed"])}


class SpectrumProcessor(StreamOp):
    def __init__(self, fft_size: int = DEFAULT_FFT_SIZE,
                 fft_average_rate: float = 0.65, scale_factor: float = 1.0,
                 peak_hold: bool = False, hide_dc: bool = False,
                 batch_shape: tuple = ()):
        self.fft_size = int(fft_size)
        self.n = self.fft_size * SPECTRUM_VZM
        self.rate = float(fft_average_rate)
        self.sf = float(scale_factor)
        self.peak_hold = peak_hold
        self.hide_dc = hide_dc
        self.bs = batch_shape

    def init_state(self):
        # Distinct arrays per leaf (shared objects break buffer donation).
        def z():
            return jnp.zeros((*self.bs, self.n), jnp.float32)

        def s():
            return jnp.zeros(self.bs, jnp.float32)

        return {
            "ma": z(), "maa": z(), "peak": z(),
            "ceil_ma": s(), "ceil_maa": s(), "floor_ma": s(),
            "floor_maa": s(), "ceil_peak": s(), "floor_peak": s(),
            "primed": jnp.zeros(self.bs, jnp.bool_),
        }

    def _frame_step(self, st, fv):
        frame, valid = fv
        mag = jnp.fft.fftshift(jnp.abs(jnp.fft.fft(frame, axis=-1)),
                               axes=-1).astype(jnp.float32)
        st2 = frame_update(self, st, mag)
        st2 = jax.tree.map(lambda a, b: jnp.where(valid, a, b), st2, st)
        return st2, None

    def _points(self, st, dc_offset_bins=None):
        """Map smoothed bins -> fft_size normalized display points."""
        maa, peak = st["maa"], st["peak"]
        if self.peak_hold:
            p_ceil, p_floor = st["ceil_peak"], st["floor_peak"]
        else:
            p_ceil, p_floor = st["ceil_maa"], st["floor_maa"]
        # VZM accumulation: average each pair of internal bins
        # (visualRatio==1 path of ref :534-576).
        acc = maa.reshape(*maa.shape[:-1], self.fft_size, SPECTRUM_VZM
                          ).mean(axis=-1)
        denom = jnp.log10((p_ceil + 0.25) - (p_floor - 0.75))[..., None]
        pts = (jnp.log10(acc + 0.25 - (p_floor[..., None] - 0.75))
               / denom) * self.sf
        out = {"spectrum_points": pts.astype(jnp.float32),
               "fft_ceiling": p_ceil / self.sf, "fft_floor": p_floor}
        if self.peak_hold:
            accp = peak.reshape(*peak.shape[:-1], self.fft_size,
                                SPECTRUM_VZM).mean(axis=-1)
            hold = (jnp.log10(accp + 0.25 - (p_floor[..., None] - 0.75))
                    / denom) * self.sf
            out["spectrum_hold_points"] = hold.astype(jnp.float32)
        if self.hide_dc and dc_offset_bins is not None:
            out["spectrum_points"] = _hide_dc(
                out["spectrum_points"], dc_offset_bins, self.fft_size)
        return out

    def apply(self, state, frames, dc_offset_bins=None, valid=None):
        """frames: [..., n_frames, fftSizeInternal] complex. Returns
        (state, display dict) for the final frame's smoothed view.
        ``valid`` ([n_frames] bool, optional) skips masked frames without a
        shape change — the distributor's fixed-capacity frames feed straight
        in (ref pacing: src/process/FFTDataDistributor.cpp:85-128)."""
        fr = jnp.moveaxis(frames, -2, 0)
        if valid is None:
            valid = jnp.ones(fr.shape[0], jnp.bool_)
        state, _ = jax.lax.scan(self._frame_step, state, (fr, valid))
        return state, self._points(state, dc_offset_bins)


def mags_to_display(core: "SpectrumProcessor", st, mags):
    """Feed raw (already fftshifted) |FFT| frames into the display EMA and
    return (state, display points). This is the host-side consumer of the
    ShardedReceiver's all-gathered ``spectrum_mags`` (SURVEY §2.11 spectrum
    assembly): the collectives deliver one magnitude frame per time shard;
    this maps them through the same smoothing/floor-ceil math the
    single-chip visual path uses."""
    for mag in np.atleast_2d(np.asarray(mags, np.float32)):
        st = frame_update(core, st, jnp.asarray(mag))
    return st, np.asarray(core._points(st)["spectrum_points"])


def _hide_dc(points, offset_bins, fft_size, width_bins=None):
    """Mirror neighbors over the DC spike (ref :578-624): bins within
    ``width_bins`` of ``offset_bins`` (position of the device center in the
    display) are replaced by their outward neighbors."""
    if width_bins is None:
        width_bins = max(fft_size // 256, 2)
    idx = jnp.arange(fft_size)
    center = jnp.asarray(offset_bins)
    d = idx - center
    # Reflect across the region edges (c-w on the left, c+w on the right).
    left = 2 * (center - width_bins) - idx - 1
    right = 2 * (center + width_bins) - idx + 1
    src = jnp.where(d < 0, left, right)
    src = jnp.clip(src, 0, fft_size - 1).astype(jnp.int32)
    mirrored = jnp.take(points, src, axis=-1)
    mask = jnp.abs(d) <= width_bins
    return jnp.where(mask, mirrored, points)


def shift_display_state(st, k: int):
    """Retune continuity: displace the smoothed averages (ma/maa, display
    order) by ``k`` bins so the waterfall stays seamless across a view
    retune instead of re-converging (ref: SpectrumVisualProcessor.cpp:
    304-336). ``k > 0`` = view center moved up = bins shift left. Vacated
    edge bins keep their stale values, exactly the reference's memmove
    without memset. Host-side control-plane event (numpy)."""
    k = int(k)
    if k == 0:
        return st
    st = dict(st)
    for key in ("ma", "maa"):
        a = np.asarray(st[key]).copy()
        if k > 0:
            a[..., :-k] = a[..., k:]
        else:
            a[..., -k:] = a[..., :k]
        st[key] = jnp.asarray(a)
    return st


def rescale_display_state(st, zoom_in: bool):
    """×2 bandwidth-change continuity (ref: SpectrumVisualProcessor.cpp:
    454-492): zooming IN expands the middle half of the old averages to the
    full display (new[i] = old[n/4 + i//2]); zooming OUT compresses the old
    display into the middle half (new[i] = old[(i - n/4)*2]) and zeroes the
    newly revealed edges."""
    st = dict(st)
    for key in ("ma", "maa"):
        a = np.asarray(st[key])
        n = a.shape[-1]
        i = np.arange(n)
        if zoom_in:
            b = a[..., n // 4 + i // 2]
        else:
            src = np.clip((i - n // 4) * 2, 0, n - 1)
            b = np.where((i >= n // 4) & (i < n - n // 4), a[..., src], 0.0)
        st[key] = jnp.asarray(b.astype(np.float32))
    return st


class SpectrumView(StreamOp):
    """Zoomed-spectrum front stage: shift the stream to the view center and
    resample to the view bandwidth, then frame for the core processor
    (ref view path: SpectrumVisualProcessor.cpp:283-386). Rebuilt on view
    change (the reference also rebuilds its resampler then)."""

    def __init__(self, input_rate: float, view_offset: float,
                 view_bandwidth: float, fft_size: int = DEFAULT_FFT_SIZE):
        self.input_rate = float(input_rate)
        self.view_offset = float(view_offset)
        # Reference halves input rate by VZM until <= bandwidth.
        bw = float(input_rate)
        while bw / SPECTRUM_VZM >= view_bandwidth:
            bw /= SPECTRUM_VZM
        self.resample_bw = bw
        self.nco = NCOMixer()
        P, Q = design_ratio(bw / input_rate, max_denominator=256)
        self.P, self.Q = P, Q
        self.resampler = RationalResampler(P, Q)
        self.fft_size = fft_size
        self.n = fft_size * SPECTRUM_VZM

    def init_state(self):
        return (self.nco.init_state(), self.resampler.init_state())

    def apply(self, state, x):
        s_n, s_r = state
        omega = -2.0 * jnp.pi * self.view_offset / self.input_rate
        s_n, y = self.nco.apply(s_n, (x, omega))
        s_r, y = self.resampler.apply(s_r, y)
        # Frame into fftSizeInternal chunks; the ragged tail is dropped
        # (static shapes; the distributor upstream already paces frames, and
        # the reference likewise FFTs only whole fftSizeInternal windows).
        n_frames = y.shape[-1] // self.n
        frames = y[..., : n_frames * self.n].reshape(
            *y.shape[:-1], n_frames, self.n)
        return (s_n, s_r), frames


class ZoomSpectrumView:
    """Managed zoomed-spectrum view — the ``is_view`` path of the
    reference's SpectrumVisualProcessor (ref: src/process/
    SpectrumVisualProcessor.cpp:283-386) with display CONTINUITY across
    view changes:

      * retune shifts the smoothed averages by the bin displacement
        (ref :304-336) via ``shift_display_state`` — the waterfall pans
        instead of blanking;
      * a ×2 bandwidth (zoom) change rescales the history (ref :454-492)
        via ``rescale_display_state``;
      * partial-input priming (ref :401-421) is absorbed by the line
        pacer's sample history (FFTDataDistributor carries fftSize-1
        samples across blocks, so every emitted frame is always full).

    Shape discipline: ONE jitted program per (bandwidth, chunk) — the
    view offset rides in as a traced NCO omega, so retunes never recompile;
    only a zoom change rebuilds the resampler (the reference rebuilds its
    msresamp then too). Host code buffers arbitrary block lengths into
    fixed Q-divisible chunks.
    """

    def __init__(self, input_rate: float, block_len: int,
                 fft_size: int = DEFAULT_FFT_SIZE,
                 lines_per_second: float = 30.0,
                 dtype=jnp.complex64, fft_average_rate: float = 0.65):
        from cubicsdr.ops.planar import PLANAR
        from cubicsdr.visual.planar_spectrum import (
            PlanarSpectrumProcessor)
        self.input_rate = float(input_rate)
        self.block_len = int(block_len)
        self.fft_size = int(fft_size)
        self.n = self.fft_size * SPECTRUM_VZM
        self.lps = float(lines_per_second)
        self.dtype = dtype
        self.planar = dtype == PLANAR
        core_cls = PlanarSpectrumProcessor if self.planar \
            else SpectrumProcessor
        self.core = core_cls(fft_size, fft_average_rate)
        self.view_offset = 0.0
        self.view_bandwidth = float(input_rate)
        self.st_core = self.core.init_state()
        # Compiled-view cache: one (nco, res, dist, jitted step) per
        # (P, Q, chunk). Repeated zoom levels reuse their program — a
        # view compile stalls the stream, so zoom in/out must never
        # re-jit a shape it has seen
        # (ref: SpectrumVisualProcessor.cpp:283-386, where the view rebuild
        # is cheap and we must match that).
        import threading
        self._front_cache: dict = {}
        self._front_lock = threading.Lock()
        self.front_cache_hits = 0
        self._warmed: set = set()        # step ids already traced+run
        self._build_front()

    def _snap_bw(self, bandwidth: float) -> float:
        """Reference halves the input rate by VZM until <= bandwidth
        (ref :289-291) — view bandwidths are input_rate / 2^k."""
        if not (float(bandwidth) > 0.0):      # also rejects NaN
            raise ValueError(
                f"view bandwidth must be > 0, got {bandwidth}")
        bw = self.input_rate
        while bw / SPECTRUM_VZM >= bandwidth:
            bw /= SPECTRUM_VZM
        return bw

    def _make_front(self, resample_bw: float):
        """Front-end program for one snapped view bandwidth, cached per
        (P, Q, chunk) so a revisited zoom level reuses its jitted step."""
        import jax
        from cubicsdr.ops.resample import design_ratio, make_resampler
        from cubicsdr.visual.distributor import FFTDataDistributor
        P, Q = design_ratio(resample_bw / self.input_rate,
                            max_denominator=1 << 16)
        chunk = Q * max(1, round(self.block_len / Q))
        key = (P, Q, chunk)
        with self._front_lock:
            ent = self._front_cache.get(key)
            if ent is not None:
                self.front_cache_hits += 1
                return ent
        nco = NCOMixer()
        res = make_resampler(P, Q, dtype=self.dtype)
        dist = FFTDataDistributor(self.n, resample_bw,
                                  lines_per_second=self.lps,
                                  block_len=res.out_len(chunk),
                                  dtype=self.dtype)
        core = self.core

        def _step(st_front, st_core, x, omega):
            s_n, s_r, s_d = st_front
            s_n, y = nco.apply(s_n, (x, omega))
            s_r, y = res.apply(s_r, y)
            s_d, (frames, valid) = dist.apply(s_d, y)
            st_core, disp = core.apply(st_core, frames, valid=valid)
            return ((s_n, s_r, s_d), st_core, disp["spectrum_points"],
                    jnp.sum(valid.astype(jnp.int32)))

        ent = (nco, res, dist, chunk, jax.jit(_step))
        with self._front_lock:
            ent = self._front_cache.setdefault(key, ent)
        return ent

    def _build_front(self):
        self.resample_bw = self._snap_bw(self.view_bandwidth)
        (self.nco, self.res, self.dist, self.chunk,
         self._step) = self._make_front(self.resample_bw)
        self._st_front = (self.nco.init_state(), self.res.init_state(),
                          self.dist.init_state())
        self._buf = np.zeros((2, 0), np.float32)
        self.points: np.ndarray | None = None

    def _warm_one(self, bw: float):
        import jax
        from cubicsdr.ops.planar import PC
        try:
            nco, res, dist, chunk, step = self._make_front(bw)
            key = id(step)
            if key in self._warmed:
                # Already traced+compiled: a dummy feed would ship a
                # full zero block to the device for nothing (zoom-on
                # churn re-warms its level every time).
                return
            z = np.zeros(chunk, np.float32)
            x = (PC(jnp.asarray(z), jnp.asarray(z)) if self.planar
                 else jnp.asarray(z.astype(np.complex64)))
            out = step((nco.init_state(), res.init_state(),
                        dist.init_state()),
                       self.core.init_state(), x, jnp.float32(0.0))
            jax.block_until_ready(out)
            self._warmed.add(key)
        except Exception:           # noqa: BLE001 — warm-up is advisory
            pass

    def prewarm_level(self, bandwidth: float):
        """Synchronously compile the view program for ``bandwidth``
        (snapped). Callers run this OUTSIDE any streaming lock before
        making the level current — the consumer feeds the view inside
        its locked dispatch, where a cold compile would stall both the
        stream and the control plane."""
        self._warm_one(self._snap_bw(float(bandwidth)))

    def prewarm_adjacent(self, background: bool = True):
        """Pre-compile the +-1 zoom-step view programs (the zoom levels one
        wheel-click away) so the first real zoom never stalls the stream
        on a cold view compile."""
        import threading
        targets = [bw for bw in (self.resample_bw / SPECTRUM_VZM,
                                 self.resample_bw * SPECTRUM_VZM)
                   if self.input_rate / (1 << 14) <= bw <= self.input_rate]

        def work():
            for bw in targets:
                self._warm_one(bw)

        if background:
            threading.Thread(target=work, daemon=True).start()
        else:
            work()

    # ---- view control (host events, continuity-preserving) --------------
    def set_view(self, offset: float, bandwidth: float):
        new_bw = self._snap_bw(float(bandwidth))
        if new_bw != self.resample_bw:
            old = self.resample_bw
            steps = int(round(abs(np.log2(new_bw / old))))
            for _ in range(steps):
                self.st_core = rescale_display_state(
                    self.st_core, zoom_in=new_bw < old)
            self.view_bandwidth = float(bandwidth)
            self._build_front()        # new resampler/pacer, fresh fronts
        freq_diff = float(offset) - self.view_offset
        if freq_diff:
            bin_per_hz = self.resample_bw / self.n
            k = int(np.floor(abs(freq_diff) / bin_per_hz))
            if 0 < k < self.n // 2:
                self.st_core = shift_display_state(
                    self.st_core, k if freq_diff > 0 else -k)
            self.view_offset = float(offset)

    # ---- streaming -------------------------------------------------------
    def feed_device(self, x):
        """Device-resident feed: ``x`` is the compiled step's full-band
        block (PC planes or complex) ALREADY on the device — no
        host->device re-upload (the host-planes ``feed`` path re-ships
        the block's f32 planes whenever the zoom is open). Requires the
        view chunk to equal the block length (the zoom Q, a power of two,
        must divide the block); returns (points, n_valid)
        DEVICE handles for the caller's deferred pull, or None when the
        chunk doesn't line up (caller falls back to host feed)."""
        if self.chunk != self.block_len:
            return None
        omega = jnp.float32(-2.0 * np.pi * self.view_offset
                            / self.input_rate)
        self._st_front, self.st_core, pts, nv = self._step(
            self._st_front, self.st_core, x, omega)
        return pts, nv

    def feed(self, planes: np.ndarray) -> np.ndarray | None:
        """planes: float32 [2, L] (re, im) host block. Buffers to the fixed
        chunk, runs the compiled view step, returns the newest display
        points (or the previous ones if no full chunk yet)."""
        from cubicsdr.ops.planar import PC
        self._buf = np.concatenate([self._buf, planes], axis=-1)
        omega = jnp.float32(-2.0 * np.pi * self.view_offset
                            / self.input_rate)
        while self._buf.shape[-1] >= self.chunk:
            cur, self._buf = (self._buf[:, :self.chunk],
                              self._buf[:, self.chunk:])
            x = (PC(jnp.asarray(cur[0]), jnp.asarray(cur[1]))
                 if self.planar else jnp.asarray(cur[0] + 1j * cur[1]))
            self._st_front, self.st_core, pts, nv = self._step(
                self._st_front, self.st_core, x, omega)
            if int(nv):
                self.points = np.asarray(pts)
        return self.points
