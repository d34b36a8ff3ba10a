"""Single-GPU throughput benchmark: IQ Msamples/s through the full
channelize + demod chain (BASELINE.json metric of record).

Six rows, one JSON line each:

  demod16   — config #4 of BASELINE.json: 16-channel polyphase channelizer
              + 16-demod FM farm at 8 MS/s, device-resident IQ, K-block
              lax.scan.
  demod256  — 256 FM demods over the same 16 channels (16 stations per
              channel): the route stage dominates.
  live16    — the LIVE APPLICATION loop on the 16-demod config:
              host-resident IQ through the native sample ring, producer
              thread, host->device puts, the donated compiled step with one
              block of dispatch lookahead, and the real fanout (waterfall
              visual program + audio tap) — the number a user gets from
              `cubicsdr serve`.
  live16_i16 — live16 with NATIVE-FORMAT ingest: int16 wire planes (what
              CS16 SDR hardware emits) shipped host->device at half the
              bytes, converted to f32 on the device.
  live16_i8 — the CS8 wire format (RTL-SDR class hardware): quarter the
              f32 bytes through host memory and the host->device link.
  multihost — the 2-process jax.distributed demo job. Its workers run on
              CPU devices, so this row measures CPU processes, not the GPU.

All rows drive the SAME class the application runs —
ReceiverPipeline(dtype=PLANAR) with squelch, control vectors, and the
audio mixer in the graph. Every row is stamped with the device it ran on
(platform, device kind, count, and the card's name and power limit) and
the host load average. The benchmark refuses to run without a GPU.

Flags: --only {demod16,demod256,live16,live16_i16,live16_i8,multihost}
(repeatable; default: all), --demods N (extra custom config), --block L.
"""

import argparse
import json
import time

import numpy as np


def build_pipeline(n_demods: int = 16, block_len: int | None = None):
    from cubicsdr.ops.planar import PLANAR
    from cubicsdr.receiver import ReceiverPipeline, DemodGroupSpec

    # Reference channel sizing: 16 channels <=> 8 MS/s capture
    # (numChannels = ceil(rate/500k), ref: SoapySDRThread.cpp:676-693),
    # keeping 500 kHz spacing so 200 kHz FM stations fit their channels.
    fs = 8_000_000
    specs = [DemodGroupSpec("FM", 200000, n_demods)]
    if block_len is None:
        # ~1M samples/block.
        m = ReceiverPipeline(fs, specs, dtype=PLANAR).group_block_multiple(0)
        block_len = max(m, ((1 << 20) // m) * m)
    rx = ReceiverPipeline(fs, specs, dtype=PLANAR, block_len=block_len)
    controls = rx.control_template()
    # Distribute demods across the 16 channels (wrapping for farms >16 —
    # the 256-demod farm packs 16 stations per channel).
    controls[0]["frequency"] = np.asarray(
        [((i % 16) - 8) * 500e3 + 20e3 for i in range(n_demods)],
        np.float32)
    return rx, controls


_STAMP: dict = {}


def _context() -> dict:
    """Device + host context stamped onto EVERY row."""
    import os
    from cubicsdr.utils.device import device_stamp
    if not _STAMP:
        _STAMP.update(device_stamp())
    ctx = {"device": dict(_STAMP)}
    try:
        ctx["host_load1"] = round(os.getloadavg()[0], 2)
    except OSError:
        pass
    return ctx


def _emit(metric: str, msps: float, extra: dict | None = None):
    row = {"metric": metric, "value": round(msps, 2),
           "unit": "Msamples/s"}
    row.update(_context())
    if extra:
        row.update(extra)
    print(json.dumps(row), flush=True)


def bench_scan(n_demods: int, block_len=None, label: str | None = None):
    """Device-resident throughput: IQ staged on device once, K blocks per
    dispatch via lax.scan (amortizes host round-trips)."""
    import jax
    import jax.numpy as jnp
    from cubicsdr.ops.planar import PC

    rx, controls = build_pipeline(n_demods, block_len)
    rng = np.random.default_rng(0)
    K = 8
    iqs = PC(jnp.asarray(rng.standard_normal((K, rx.block_len))
                         .astype(np.float32)),
             jnp.asarray(rng.standard_normal((K, rx.block_len))
                         .astype(np.float32)))

    def multi_step(state, iqs):
        def body(s, iq):
            s, out = rx.apply(s, (iq, controls))
            level = jnp.concatenate(
                [g["level"] for g in out["groups"]], axis=-1)
            return s, (out["mix"], level)
        return jax.lax.scan(body, state, iqs)

    step = jax.jit(multi_step, donate_argnums=(0,))
    state = rx.init_state()
    for _ in range(2):
        state, outs = step(state, iqs)
    jax.block_until_ready(outs)

    n_iters = 15
    t0 = time.perf_counter()
    for _ in range(n_iters):
        state, outs = step(state, iqs)
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0

    msps = K * rx.block_len * n_iters / dt / 1e6
    _emit(label or f"iq_msamples_per_sec_per_device_channelize_demod"
          f"{n_demods}", msps)
    return msps


def bench_live(n_demods: int = 16, n_blocks: int = 240,
               block_len=None, ingest_dtype=None):
    """The LIVE path: host numpy blocks -> native SampleRing (producer
    thread) -> LiveReceiver.run_blocks (donated step + lookahead fanout:
    waterfall visual program, audio mix tap). Measures sustained MS/s and
    reports ring drops — the number `cubicsdr rx` delivers.

    ingest_dtype=int16 measures native-format ingest: wire-width planes
    to the device, converted there (half the host->device bytes; the
    format real CS16 SDR hardware emits)."""
    from cubicsdr.app.runner import LiveReceiver

    rx, controls = build_pipeline(n_demods, block_len)
    L = rx.block_len
    rng = np.random.default_rng(1)
    # Pre-generated host blocks, cycled: the producer measures the ring +
    # transfer path, not numpy RNG throughput.
    if ingest_dtype is not None and np.dtype(ingest_dtype) != np.float32:
        k = float(np.iinfo(ingest_dtype).max // 2)
        blocks = [np.ascontiguousarray(
            (rng.standard_normal((2, L)) * 0.25 * k).astype(ingest_dtype))
            for _ in range(4)]
    else:
        blocks = [np.ascontiguousarray(
            rng.standard_normal((2, L)).astype(np.float32))
            for _ in range(4)]

    class _CycleSource:
        """Unthrottled host source with back-pressure: waits for ring
        space instead of shedding, so measured throughput is the live
        loop's capability and drops stay a real health signal."""

        def __init__(self):
            self.stop_flag = False
            self.ring = None                 # late-bound (the lr's ring)

        def __iter__(self):
            i = 0
            while not self.stop_flag:
                while (self.ring is not None
                       and self.ring.fill + L > self.ring.capacity
                       and not self.stop_flag):
                    time.sleep(0.0002)
                yield blocks[i % len(blocks)]
                i += 1

        def stop(self):
            self.stop_flag = True

    src = _CycleSource()
    lr = LiveReceiver(rx, controls, src, waterfall_fft=1024,
                      waterfall_lines=64, ring_seconds=1.0,
                      ingest_dtype=ingest_dtype)
    src.ring = lr.ring
    lr.start_producer()
    lr.run_blocks(max_blocks=8)              # warm-up / compile
    lr.metrics = type(lr.metrics)()          # reset counters for the run
    t0 = time.perf_counter()
    n = lr.run_blocks(max_blocks=n_blocks)
    dt = time.perf_counter() - t0
    snap = lr.metrics.snapshot() if hasattr(lr.metrics, "snapshot") else {}
    lr.stop()
    msps = n * L / dt / 1e6
    drops = int(snap.get("ingest", {}).get("dropped", 0))
    tag = "" if ingest_dtype is None else f"_{np.dtype(ingest_dtype).name}"
    _emit(f"iq_msamples_per_sec_per_device_live_loop_demod{n_demods}{tag}",
          msps, {"blocks": n, "ring_dropped_samples": drops})
    return msps


def bench_multihost(timed_steps: int = 16):
    """Machine-readable multi-PROCESS scaling: the real 2-process
    jax.distributed receive job (per-process ingest spans, gloo
    collectives over loopback) timed at steady state vs the same job at
    1 process, on CPU worker processes. CAVEAT attached to the row: both
    fleets share THIS host's cores, so the 2-process number
    under-measures real multi-host scaling — the honest signal is the
    ingest-scatter share and that the collective-synchronized loop
    sustains throughput at all."""
    import os
    from cubicsdr.parallel import multihost
    reps = {}
    for n in (1, 2):
        rs = multihost.launch_local(n, steps=1, timed_steps=timed_steps)
        timed = [r["timed"] for r in rs if r.get("timed")]
        reps[n] = {
            "aggregate_msps": round(
                sum(t["aggregate_msps"] for t in timed) / len(timed), 2),
            "ingest_scatter_share": round(
                max(t["ingest_scatter_share"] for t in timed), 4)}
    m1, m2 = reps[1]["aggregate_msps"], reps[2]["aggregate_msps"]
    _emit("iq_msamples_per_sec_multihost_2proc", m2, {
        "aggregate_msps_1proc": m1,
        "scaling_vs_1proc": round(m2 / m1, 3),
        "efficiency_vs_2x": round(m2 / (2 * m1), 3),
        "ingest_scatter_share": reps[2]["ingest_scatter_share"],
        "host_cpus": os.cpu_count(),
        "caveat": "CPU worker processes sharing one host's cores "
                  "(loopback stand-in for a multi-host job); not a GPU "
                  "measurement"})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", action="append",
                    choices=["demod16", "demod256", "live16", "live16_i16",
                             "live16_i8", "multihost"],
                    help="run a subset (default: all six)")
    ap.add_argument("--demods", type=int, default=None,
                    help="extra custom scan config with N demods")
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--live-blocks", type=int, default=240)
    args = ap.parse_args()

    from cubicsdr.utils.compile_cache import enable_compile_cache
    from cubicsdr.utils.device import require_gpu
    enable_compile_cache()
    require_gpu()
    configs = args.only or ["demod16", "demod256", "live16", "live16_i16",
                            "live16_i8", "multihost"]
    if args.demods is not None:
        bench_scan(args.demods, args.block)
        return
    if "demod16" in configs:
        bench_scan(16, args.block)
    if "demod256" in configs:
        bench_scan(256, args.block)
    if "live16" in configs:
        bench_live(16, args.live_blocks, args.block)
    if "live16_i16" in configs:
        bench_live(16, args.live_blocks, args.block,
                   ingest_dtype=np.int16)
    if "live16_i8" in configs:
        # CS8 wire format (RTL-SDR class hardware): quarter the bytes of
        # f32 through host memory and the host->device link.
        bench_live(16, args.live_blocks, args.block,
                   ingest_dtype=np.int8)
    if "multihost" in configs:
        bench_multihost()


if __name__ == "__main__":
    main()
