#!/usr/bin/env python3
"""On-card smoke test: the receiver's main path on one GPU, checked.

    python chip_smoke.py [--seed N]         # one GPU (the default)
    python chip_smoke.py --four-cards       # the sharded path on 4 GPUs

Phases (one card), each printed as a JSON line:

  flagship   ReceiverPipeline at 8 MS/s, 16 PFBCH2 channels, ~1M-sample
             blocks, 16- and 256-demod FM farms: compile, memory analysis,
             peak device memory, steady MS/s. The 16-demod step is checked
             against the same step on the CPU backend, and every row of
             the 256-demod step against the 16-demod row with the same
             station.
  fidelity   the mixed analog + digital plan at 2.4 MS/s (six channels)
             against the CPU-exact chain (cubicsdr.receiver.fidelity).
  live       LiveReceiver, cs16 wire format through the SampleRing, a
             real-time-paced 8 MS/s source, 16 demods: zero ring drops.
  cli        ``cli.main(["rx", session, capture, "-o", wav])`` in-process,
             and the 1 kHz tone read back from the WAV.
  kernels    the plain XLA channelizer and both XLA route forms at the
             256-demod shape, each timed against its memory-traffic bound.

``--four-cards`` runs only ShardedReceiver on a time=2 x chan=2 mesh at the
8 MS/s, 256-demod shape against the one-card ReceiverPipeline.

The process refuses to run (non-zero exit, no result) where JAX's default
devices are not GPUs. Every phase runs; if any failed, the exit code is 1
and the last line is not printed. The last line on success is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import traceback

import numpy as np

from cubicsdr.ops.planar import PC, PLANAR, pc_take
from cubicsdr.receiver import DemodGroupSpec, ReceiverPipeline
from cubicsdr.receiver import fidelity

FS = 8_000_000.0
NUM_CHANNELS = 16
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet (HBM3)
TOL = fidelity.MIX_TOL


def _check(ok, what: str):
    """A phase's verdict (an exception, so ``python -O`` cannot drop it)."""
    if not ok:
        raise RuntimeError(what)


def _emit(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}, default=float), flush=True)


def farm_freqs(n: int) -> np.ndarray:
    """Demod i listens to station i % 15: one per channel, 20 kHz off its
    center, clear of the +-FS/2 wrap (a station straddling it fades in and
    out of its channel)."""
    return np.asarray([((i % 15) - 7) * 500e3 + 20e3 for i in range(n)],
                      np.float32)


def farm_block_len() -> int:
    m = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, 1)],
                         num_channels=NUM_CHANNELS,
                         dtype=PLANAR).group_block_multiple(0)
    return max(m, (1 << 20) // m * m)


def farm_capture(n: int, seed: int) -> np.ndarray:
    """The 15 FM stations of ``farm_freqs`` (tones 700 + 90 k Hz, 75 kHz
    deviation) plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    iq = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for k, f0 in enumerate(farm_freqs(15)):
        msg = np.sin(2 * np.pi * (700.0 + 90.0 * k) * t)
        iq = iq + 0.5 * np.exp(1j * (2 * np.pi * f0 * t
                                     + 2 * np.pi * 75e3 * np.cumsum(msg)
                                     / FS))
    return iq.astype(np.complex64)


def farm_pipeline(n_demods: int, block_len: int):
    rx = ReceiverPipeline(FS, [DemodGroupSpec("FM", 200000, n_demods)],
                          num_channels=NUM_CHANNELS, dtype=PLANAR,
                          block_len=block_len)
    controls = rx.control_template()
    controls[0]["frequency"] = farm_freqs(n_demods)
    return rx, controls


def _planes(blk, device):
    import jax
    return PC(jax.device_put(np.ascontiguousarray(blk.real), device),
              jax.device_put(np.ascontiguousarray(blk.imag), device))


def _mem(compiled) -> dict:
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def run_farm(n_demods: int, block_len: int, iq: np.ndarray, device,
             timed_blocks: int = 0):
    """Stream ``iq`` through the FM farm on ``device``; returns the host
    outputs of every block (audio [N, 1, T], mix [2, T]) and, when
    ``timed_blocks``, compile/memory/throughput figures."""
    import jax
    with jax.default_device(device):
        rx, controls = farm_pipeline(n_demods, block_len)
        state = rx.init_state()
        blocks = [_planes(iq[b * block_len:(b + 1) * block_len], device)
                  for b in range(len(iq) // block_len)]
        t0 = time.perf_counter()
        step = jax.jit(rx.apply, donate_argnums=(0,)).lower(
            state, (blocks[0], controls)).compile()
        info = {"compile_s": time.perf_counter() - t0, "memory": _mem(step)}
        audio, mix = [], []
        for x in blocks:
            state, out = step(state, (x, controls))
            audio.append(np.asarray(out["groups"][0]["audio"]))
            mix.append(np.asarray(out["mix"]))
        if timed_blocks:
            jax.block_until_ready(state)
            t0 = time.perf_counter()
            for i in range(timed_blocks):
                state, out = step(state, (blocks[i % len(blocks)],
                                          controls))
            jax.block_until_ready(out)
            dt = time.perf_counter() - t0
            info["steady_msps"] = timed_blocks * block_len / dt / 1e6
            stats = device.memory_stats() or {}
            info["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return (np.concatenate(audio, axis=-1), np.concatenate(mix, axis=-1),
            info)


def phase_flagship(gpu, cpu, seed: int, n_blocks: int = 3,
                   block_len: int | None = None, timed_blocks: int = 16,
                   big: int = 256):
    L = block_len or farm_block_len()
    iq = farm_capture(n_blocks * L, seed)
    a16, m16, info16 = run_farm(16, L, iq, gpu, timed_blocks)
    _emit("flagship", demods=16, block_len=L, **info16)
    a_ref, m_ref, _ = run_farm(16, L, iq, cpu)
    d_cpu = float(np.max(np.abs(m16 - m_ref)))
    d_cpu_rows = float(np.max(np.abs(a16 - a_ref)))
    a256, _, info256 = run_farm(big, L, iq, gpu, timed_blocks)
    _emit("flagship", demods=big, block_len=L, **info256)
    d_rows = float(np.max(np.abs(a256 - a16[np.arange(big) % 15])))
    ok = (np.isfinite(a256).all() and a256.shape[0] == big
          and d_cpu <= TOL and d_cpu_rows <= TOL and d_rows <= TOL)
    _emit("flagship_check", mix16_vs_cpu_max_abs=d_cpu,
          audio16_vs_cpu_max_abs=d_cpu_rows,
          audio256_vs_audio16_max_abs=d_rows, tol=TOL, ok=bool(ok))
    _check(ok, "flagship outputs disagree")


def phase_fidelity(gpu, cpu, seed: int, n_blocks: int = 6,
                   block_len: int | None = None):
    L = block_len or 27 * fidelity.block_multiple()      # 518400
    res = fidelity.fidelity_check(gpu, cpu, L, n_blocks, seed)
    _emit("fidelity", **res)
    _check(res["ok"], "fidelity bars not met")


class PacedSource:
    """Yields planar int16 blocks at the capture's real-time rate.
    ``reset()`` re-bases the schedule to now, so a compile pause does not
    leave a backlog that then arrives at full speed."""

    def __init__(self, blocks, block_len: int, rate: float):
        self.blocks, self.L, self.rate = blocks, block_len, rate
        self.stopping = False
        self.reset()

    def reset(self):
        self._t0, self._i = time.perf_counter(), 0

    def __iter__(self):
        while not self.stopping:
            due = self._t0 + (self._i + 1) * self.L / self.rate
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            yield self.blocks[self._i % len(self.blocks)]
            self._i += 1

    def stop(self):
        self.stopping = True


def phase_live(gpu, seed: int, seconds: float = 5.0,
               block_len: int | None = None):
    import jax
    from cubicsdr.app.runner import LiveReceiver
    from cubicsdr.utils.metrics import Metrics
    L = block_len or farm_block_len()
    iq = farm_capture(4 * L, seed)
    raw = np.stack([iq.real, iq.imag]) * 32767.0 / 8.0
    blocks = [np.ascontiguousarray(raw[:, b * L:(b + 1) * L]
                                   .astype(np.int16)) for b in range(4)]
    with jax.default_device(gpu):
        rx, controls = farm_pipeline(16, L)
        src = PacedSource(blocks, L, FS)
        lr = LiveReceiver(rx, controls, src, waterfall_fft=1024,
                          waterfall_lines=64, ring_seconds=2.0,
                          ingest_dtype=np.int16)
        try:
            lr.start_producer()
            lr.run_blocks(max_blocks=4)          # compile + warm
            src.reset()
            lr.metrics = Metrics()
            t0 = time.perf_counter()
            n = 0
            while time.perf_counter() - t0 < seconds:
                n += lr.run_blocks(max_blocks=4)
            dt = time.perf_counter() - t0
            snap = lr.metrics.snapshot()
        finally:
            src.stop()
            lr.stop()
    drops = int(snap.get("ingest", {}).get("dropped", 0))
    msps = n * L / dt / 1e6
    ring = "native" if lr.ring._lib is not None else "numpy"
    ok = drops == 0 and n > 0 and msps >= 0.98 * FS / 1e6
    _emit("live", ring=ring, wire="cs16", blocks=n, seconds=dt,
          sustained_msps=msps, realtime_factor=msps * 1e6 / FS,
          ring_dropped_samples=drops, ok=bool(ok))
    _check(ok, "live loop dropped samples or fell behind real time")


def phase_cli(seconds: float = 2.0):
    from cubicsdr.app.cli import main as cli_main
    from cubicsdr.app.session import SessionMgr
    from cubicsdr.io.wav import read_wav
    from cubicsdr.receiver import DemodulatorMgr
    rate, center, off = 2_400_000, 100_000_000, 300e3
    with tempfile.TemporaryDirectory() as tmp:
        mgr = DemodulatorMgr()
        mgr.new_demodulator(center + off, "FM", 200000)
        sess = SessionMgr(mgr)
        sess.center_freq, sess.sample_rate = center, rate
        sess_path = sess.save_session(os.path.join(tmp, "session.json"))
        n = int(seconds * rate)
        t = np.arange(n) / rate
        msg = np.sin(2 * np.pi * 1000.0 * t)
        iq = 0.8 * np.exp(1j * (2 * np.pi * off * t
                                + 2 * np.pi * 75e3 * np.cumsum(msg) / rate))
        cap = os.path.join(tmp, "capture.cf32")
        iq.astype(np.complex64).tofile(cap)
        wav = os.path.join(tmp, "mix.wav")
        rc = cli_main(["rx", sess_path, cap, "-o", wav])
        audio, fs = read_wav(wav)
    a = np.asarray(audio[0], np.float64)         # [channels, n] -> left
    a = a[len(a) // 4:]
    spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(len(a))))
    f = np.fft.rfftfreq(len(a), 1.0 / fs)
    peak = float(f[int(np.argmax(spec))])
    snr = fidelity.tone_snr_db(a, 1000.0, fs)
    ok = rc == 0 and abs(peak - 1000.0) < 5.0 and snr > 40.0
    _emit("cli", rc=rc, wav_rate=fs, frames=audio.shape[-1], peak_hz=peak,
          tone_snr_db=snr, ok=bool(ok))
    _check(ok, "CLI rx WAV tone check failed")


def _time(fn, *args, iters: int = 20) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def route_inputs(rx, seed: int):
    """Channel matrix (with the first resampler stage's history), routing
    and NCO inputs of ``rx``'s route stage, as host arrays."""
    from cubicsdr.ops.channelizer import channel_centers
    from cubicsdr.receiver.frontend import shift_omegas
    rs = rx.frontends[0]._stage1
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, rx.M, rs.hist_len + rx._chan_len)
                            ).astype(np.float32)
    freqs = farm_freqs(rx.groups[0].count)
    centers = channel_centers(rx.M, rx.sample_rate).astype(np.float32)
    ci = np.argmin(np.abs(freqs[:, None] - centers[None, :]), axis=-1)
    omega = np.asarray(shift_omegas(freqs, centers[ci], rx.chan_rate))
    phase = rng.uniform(0, 2 * np.pi, len(freqs)).astype(np.float32)
    return z, ci.astype(np.int32), omega, phase


def phase_kernels(gpu, cpu, seed: int, block_len: int | None = None,
                  n_demods: int = 256):
    """Plain-XLA timings for the two stages that had hand-written kernels,
    each against the least memory traffic it needs at 3.35 TB/s."""
    import jax
    from cubicsdr.ops.channelizer import ChannelizerPFB2
    from cubicsdr.ops.resample import (planar_shifted_resample_conv,
                                       planar_shifted_resample_matmul)
    L = block_len or farm_block_len()
    rng = np.random.default_rng(seed)
    res = {"block_len": L, "hbm_bytes_per_s": HBM_BYTES_PER_S}
    with jax.default_device(gpu):
        ch = ChannelizerPFB2(NUM_CHANNELS, dtype=PLANAR)
        x = _planes((rng.standard_normal(L)
                     + 1j * rng.standard_normal(L)).astype(np.complex64),
                    gpu)
        f = jax.jit(ch.apply)
        t = _time(f, ch.init_state(), x)
        nbytes = 8 * (L + ch.hist_len) + 8 * 2 * L     # planes in + out
        res["channelizer"] = {"M": NUM_CHANNELS, "s": t, "bytes": nbytes,
                              "bound_s": nbytes / HBM_BYTES_PER_S}

        rx, _ = farm_pipeline(n_demods, L)
        rs = rx.frontends[0]._stage1
        z, ci, omega, phase = route_inputs(rx, seed)
        zg = PC(jax.device_put(z[0], gpu), jax.device_put(z[1], gpu))
        args = (zg, jax.device_put(ci, gpu), jax.device_put(omega, gpu),
                jax.device_put(phase, gpu))
        forms = {"matmul": planar_shifted_resample_matmul,
                 "conv": planar_shifted_resample_conv}
        outs = {}
        N, W = n_demods, rs.hist_len + rx._chan_len
        n_out = rx._chan_len // rs.Q * rs.P
        # The conv form's own traffic: the gathered [N, W] planes written
        # once and read by two convs each, plus the output planes. The
        # least any form needs: the channel matrix in, the outputs out.
        conv_bytes = 3 * N * W * 8 + N * n_out * 8
        least_bytes = NUM_CHANNELS * W * 8 + N * n_out * 8
        for name, form in forms.items():
            fn = jax.jit(lambda z, ci, om, ph, form=form: form(
                pc_take(z, ci, axis=-2), rs, om, ph))
            outs[name] = fn(*args)
            res[f"route_{name}"] = {"s": _time(fn, *args)}
        res["route_bytes"] = {"conv_form": conv_bytes, "least": least_bytes,
                              "conv_form_bound_s": conv_bytes
                              / HBM_BYTES_PER_S,
                              "least_bound_s": least_bytes / HBM_BYTES_PER_S}
    # The default (matmul) form against the same jitted form on the CPU,
    # on 16 rows. The conv form is reported, not held to a bar: its f32
    # output-phase bookkeeping reaches ~2.5e3 rad at these block lengths,
    # so two backends' rounding of it differs by ~1e-4..1e-2 relative.
    sub = slice(0, 16)
    with jax.default_device(cpu):
        ref = jax.jit(lambda z, ci, om, ph: planar_shifted_resample_matmul(
            pc_take(z, ci, axis=-2), rs, om, ph))(
            PC(jax.device_put(z[0], cpu), jax.device_put(z[1], cpu)),
            ci[sub], omega[sub], phase[sub])
    scale = float(np.max(np.abs(np.asarray(ref[0]))))
    d_cpu = max(float(np.max(np.abs(np.asarray(outs["matmul"][i])[sub]
                                    - np.asarray(ref[i]))))
                for i in range(2))
    d_forms = max(float(np.max(np.abs(np.asarray(outs["matmul"][i])
                                      - np.asarray(outs["conv"][i]))))
                  for i in range(2))
    res["route_check"] = {"matmul_vs_cpu_max_abs": d_cpu,
                          "conv_vs_matmul_max_abs": d_forms,
                          "output_scale": scale}
    # tests/test_resample_chain.py's bound for the route forms.
    ok = d_cpu <= 4e-4 * scale
    _emit("kernels", ok=bool(ok), **res)
    _check(ok, "route matmul form disagrees with the CPU")


def phase_four_cards(devices, seed: int, n_demods: int = 256,
                     n_blocks: int = 2, fs: float = FS,
                     num_channels: int = NUM_CHANNELS,
                     target_len: int = 1 << 20):
    """ShardedReceiver on a time=2 x chan=2 mesh vs the one-card pipeline
    at the same block length, to the sharded tests' tolerance."""
    import jax
    from cubicsdr.ops.planar import from_complex
    from cubicsdr.parallel import make_receiver_mesh
    from cubicsdr.parallel.sharded import ShardedReceiver
    _check(len(devices) == 4, f"needs four devices, got {devices}")
    mesh = make_receiver_mesh(n_time=2, n_chan=2, devices=devices)
    groups = [DemodGroupSpec("FM", 200000, n_demods)]
    m = 2 * ShardedReceiver(fs, num_channels, groups=groups,
                            mesh=mesh).local_multiple
    rx = ShardedReceiver(fs, num_channels, groups=groups, mesh=mesh,
                         block_len=max(m, target_len // m * m))
    L = rx.block_len
    controls = rx.control_template()
    controls[0]["frequency"] = farm_freqs(n_demods)
    iq = farm_capture(n_blocks * L, seed)
    with jax.default_device(devices[0]):
        pipe = ReceiverPipeline(fs, groups, num_channels=num_channels,
                                dtype=PLANAR, block_len=L)
        step_p = jax.jit(pipe.apply)
        st_p = pipe.init_state()
    step_s = rx.make_step()
    st_s = rx.place_state(rx.init_state())
    worst = {"mix": 0.0, "audio": 0.0, "level": 0.0}
    for b in range(n_blocks):
        blk = iq[b * L:(b + 1) * L]
        st_s, out_s = step_s(st_s, rx.shard_iq(blk), controls)
        with jax.default_device(devices[0]):
            st_p, out_p = step_p(st_p, (from_complex(blk), controls))
        for key, a, b_ in (("mix", out_s["mix"], out_p["mix"]),
                           ("audio", out_s["groups"][0]["audio"],
                            out_p["groups"][0]["audio"])):
            a, b_ = np.asarray(a), np.asarray(b_)
            np.testing.assert_allclose(a, b_, atol=3e-3, rtol=1e-3)
            worst[key] = max(worst[key], float(np.max(np.abs(a - b_))))
        lv_s = np.asarray(out_s["groups"][0]["level"])
        lv_p = np.asarray(out_p["groups"][0]["level"])
        np.testing.assert_allclose(lv_s, lv_p, atol=0.05)
        worst["level"] = max(worst["level"],
                             float(np.max(np.abs(lv_s - lv_p))))
    jax.block_until_ready((st_s, out_s))
    # Steady rate of both, for information: one block, re-fed.
    x_s = rx.shard_iq(blk)
    with jax.default_device(devices[0]):
        x_p = from_complex(blk)
    rate = {}
    for name, run in (("sharded", lambda st: step_s(st, x_s, controls)),
                      ("one_card", lambda st: step_p(st, (x_p, controls)))):
        st = st_s if name == "sharded" else st_p
        st, out = run(st)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(8):
            st, out = run(st)
        jax.block_until_ready(out)
        rate[name] = 8 * L / (time.perf_counter() - t0) / 1e6
        if name == "sharded":
            st_s = st

    def spread(arr) -> int:
        """Distinct non-empty slices the devices hold."""
        return len({tuple((i.start, i.stop) for i in sh.index)
                    for sh in arr.addressable_shards if sh.data.size})

    placed = {"audio": spread(out_s["groups"][0]["audio"]),
              "demod_state": min(spread(a) for a in
                                 jax.tree.leaves(st_s["groups"])),
              "mix": spread(out_s["mix"])}
    # A GPU reports its peak memory; the CPU backend reports none.
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]
    ok = (placed["audio"] == 4 and placed["demod_state"] == 4
          and all(p is None or p > 0 for p in peaks))
    _emit("four_cards", mesh={"time": 2, "chan": 2}, demods=n_demods,
          block_len=L, max_abs_diff=worst, tol={"atol": 3e-3, "rtol": 1e-3},
          devices_holding=placed, peak_bytes_in_use=peaks,
          steady_msps=rate, ok=bool(ok))
    _check(ok, "sharded outputs or state not spread over all four devices")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax
    from cubicsdr.utils.compile_cache import enable_compile_cache
    from cubicsdr.utils.device import require_gpu
    stamp = require_gpu()
    cache = enable_compile_cache()
    print(stamp["card"], flush=True)
    _emit("device", compile_cache=cache, **stamp)
    gpus = jax.devices()
    cpu = jax.devices("cpu")[0]

    if args.four_cards:
        if len(gpus) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, JAX has "
                             f"{len(gpus)}")
        phases = [("four_cards",
                   lambda: phase_four_cards(gpus[:4], args.seed))]
    else:
        gpu = gpus[0]
        phases = [
            ("flagship", lambda: phase_flagship(gpu, cpu, args.seed)),
            ("fidelity", lambda: phase_fidelity(gpu, cpu, args.seed)),
            ("live", lambda: phase_live(gpu, args.seed)),
            ("cli", phase_cli),
            ("kernels", lambda: phase_kernels(gpu, cpu, args.seed)),
        ]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
        except Exception:                     # noqa: BLE001 — reported
            traceback.print_exc()
            failed.append(name)
        _emit("timing", name=name, seconds=time.perf_counter() - t0)
    if failed:
        print(f"FAILED phases: {failed}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": stamp["platform"], "kind": stamp["kind"],
        "count": stamp["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
