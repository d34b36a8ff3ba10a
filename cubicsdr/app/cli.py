"""Command-line shell — the headless CubicSDR application.

Replaces the wxApp shell (ref: src/CubicSDR.cpp OnInit/OnExit + cmdline
flags CubicSDR.h:259-268) with subcommands:

  demod      one receiver: IQ capture -> audio WAV
  rx         session file -> every demodulator -> WAVs + stereo mix
  waterfall  IQ capture -> spectrum/waterfall PNG
  modems     list registered modem types + settings schemas
  bench      single-device throughput benchmark (same as bench.py)

Frequency strings accept the reference's forms ("100.1", "100.1M",
"98700k", raw Hz; ref: CubicSDR.cpp:80-141 frequency parsing).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from cubicsdr.ops.planar import PLANAR, from_complex
from cubicsdr.utils.compile_cache import enable_compile_cache


def parse_frequency(s) -> float:
    """'100.1' (MHz if small), '100.1M', '98700k', '2.4G', else Hz
    (ref: CubicSDR::strToFrequency semantics)."""
    if isinstance(s, (int, float)):
        return float(s)
    s = s.strip().lower().replace("hz", "")
    mult = 1.0
    if s.endswith("g"):
        mult, s = 1e9, s[:-1]
    elif s.endswith("m"):
        mult, s = 1e6, s[:-1]
    elif s.endswith("k"):
        mult, s = 1e3, s[:-1]
    v = float(s) * mult
    if mult == 1.0 and v < 3000:        # bare small number = MHz convention
        v *= 1e6
    return v


def format_frequency(f: float) -> str:
    if f >= 1e9:
        return f"{f/1e9:.6f} GHz"
    if f >= 1e6:
        return f"{f/1e6:.6f} MHz"
    if f >= 1e3:
        return f"{f/1e3:.3f} kHz"
    return f"{f:.0f} Hz"


def cmd_demod(args):
    import jax
    import jax.numpy as jnp
    from cubicsdr.io import FileIQSource, WavWriter
    from cubicsdr.receiver import (
        DemodulatorMgr, ReceiverPipeline, plan_from_manager,
        controls_from_manager)

    center = parse_frequency(args.center)
    freq = parse_frequency(args.frequency)
    mgr = DemodulatorMgr()
    d = mgr.new_demodulator(freq, args.modem, args.bandwidth)
    if args.squelch is not None:
        d.squelch_enabled = True
        d.squelch_level = args.squelch
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(args.rate, specs, chan_mode=args.channelizer,
                          dtype=PLANAR)
    controls = controls_from_manager(mgr, rx, keyed, center)
    src = FileIQSource(args.input, args.rate, rx.block_len,
                       frequency=center)
    step = jax.jit(rx.apply)
    state = rx.init_state()
    w = WavWriter(args.output, 48000, 1)
    nblocks = 0
    for blk in src:
        state, out = step(state, (from_complex(blk), controls))
        w.write(np.asarray(out["groups"][0]["audio"][0]))
        nblocks += 1
        if args.max_seconds and nblocks * rx.block_len / args.rate \
                >= args.max_seconds:
            break
    w.close()
    lvl = float(np.asarray(out["groups"][0]["level"])[0])
    print(f"wrote {w.current_path}: {nblocks} blocks, "
          f"signal {lvl:.1f} dB")


def cmd_waterfall(args):
    import jax
    import jax.numpy as jnp
    from cubicsdr.io import FileIQSource
    from cubicsdr.visual import (
        FFTDataDistributor, PlanarSpectrumProcessor, Waterfall)

    src = FileIQSource(args.input, args.rate,
                       block_len=1 << 17)
    dist = FFTDataDistributor(args.fft_size * 2, args.rate,
                              lines_per_second=args.lps,
                              block_len=1 << 17, dtype=PLANAR)
    sp = PlanarSpectrumProcessor(args.fft_size)
    wf = Waterfall(args.fft_size, lines=args.lines, theme=args.theme)

    st_d, st_s = dist.init_state(), sp.init_state()

    @jax.jit
    def step(st_d, st_s, x):
        st_d, (frames, valid) = dist.apply(st_d, x)
        st_s, out = sp.apply(st_s, frames, valid=valid)
        return st_d, st_s, out, valid

    n_lines = 0
    for blk in src:
        st_d, st_s, out, valid = step(st_d, st_s, from_complex(blk))
        nv = int(np.asarray(valid).sum())
        if nv:
            pts = np.asarray(out["spectrum_points"])
            wf.add_lines(np.tile(pts, (nv, 1)))
            n_lines += nv
        if n_lines >= args.lines:
            break
    wf.render_png(args.output)
    print(f"wrote {args.output}: {n_lines} lines, fft {args.fft_size}, "
          f"floor {float(np.asarray(out['fft_floor'])):.2f}")


def cmd_rx(args):
    import jax
    import jax.numpy as jnp
    from cubicsdr.app.session import SessionMgr
    from cubicsdr.io import FileIQSource, WavWriter
    from cubicsdr.receiver import (
        DemodulatorMgr, ReceiverPipeline, plan_from_manager,
        controls_from_manager)

    mgr = DemodulatorMgr()
    sess = SessionMgr(mgr)
    if not sess.load_session(args.session):
        print(f"cannot load session {args.session}", file=sys.stderr)
        return 1
    specs, keyed = plan_from_manager(mgr)
    if args.mesh:
        return _rx_sharded(args, mgr, sess, specs, keyed)
    rx = ReceiverPipeline(sess.sample_rate, specs,
                          chan_mode=args.channelizer, dtype=PLANAR)
    controls = controls_from_manager(mgr, rx, keyed, sess.center_freq)
    src = FileIQSource(args.input, sess.sample_rate, rx.block_len)
    step = jax.jit(rx.apply)
    state = rx.init_state()
    mix_w = WavWriter(args.output, 48000, 2)
    player = None
    if args.play:
        from cubicsdr.io.audio_out import AudioOutput
        player = AudioOutput(48000, 2, backend=args.play)
    for blk in src:
        state, out = step(state, (from_complex(blk), controls))
        mix = np.asarray(out["mix"])
        mix_w.write(mix)
        if player is not None:
            player.write(mix)
    mix_w.close()
    if player is not None:
        player.close()
    print(f"wrote {mix_w.current_path} "
          f"({len(mgr.get_demodulators())} demods mixed)")


def _rx_sharded(args, mgr, sess, specs, keyed):
    """Session rx on a device MESH (SURVEY §7 step 7 as an application,
    not a bench): ShardedReceiver end-to-end — halo-exchanged channelizer,
    chan-sharded demod rows, psum mix into the WAV, the all-gather spectrum
    feeding the waterfall PNG, per-demod recording taps, and bit-continuous
    checkpoint save/restore of the PLACED state."""
    import jax
    from cubicsdr.app.checkpoint import save_state, load_state
    from cubicsdr.io import FileIQSource, WavWriter
    from cubicsdr.io.recorder import RecordingSink
    from cubicsdr.io.sources import optimal_channel_count
    from cubicsdr.parallel import make_receiver_mesh
    from cubicsdr.parallel.sharded import ShardedReceiver
    from cubicsdr.receiver import controls_from_manager
    from cubicsdr.visual import Waterfall
    from cubicsdr.visual.spectrum import (SpectrumProcessor,
                                          mags_to_display)

    kv = dict(p.split("=") for p in args.mesh.split(","))
    nt, nc = int(kv.get("time", 1)), int(kv.get("chan", 1))
    if nt * nc > len(jax.devices()):
        print(f"mesh {nt}x{nc} needs {nt * nc} devices, have "
              f"{len(jax.devices())}", file=sys.stderr)
        return 1
    mesh = make_receiver_mesh(n_time=nt, n_chan=nc,
                              devices=jax.devices()[: nt * nc])
    fft = args.fft_size
    rx = ShardedReceiver(sess.sample_rate,
                         num_channels=optimal_channel_count(
                             sess.sample_rate),
                         groups=specs, mesh=mesh, spectrum_fft=fft)
    controls = controls_from_manager(mgr, rx, keyed, sess.center_freq)
    state = rx.init_state()
    if args.checkpoint and os.path.exists(args.checkpoint):
        state, meta = load_state(args.checkpoint, state)
        print(f"resumed from {args.checkpoint} "
              f"(block {meta.get('blocks', '?')})")
    state = rx.place_state(state)
    step = rx.make_step()

    src = FileIQSource(args.input, sess.sample_rate, rx.block_len)
    mix_w = WavWriter(args.output, rx.audio_rate, 2)
    core = SpectrumProcessor(fft)
    st_sp = core.init_state()
    wf = Waterfall(fft, max(32, src.n_samples // rx.block_len * nt))
    recorders: dict[int, RecordingSink] = {}
    n_blocks = 0
    for blk in src:
        state, out = step(state, rx.shard_iq(blk), controls)
        mix_w.write(np.asarray(out["mix"]))
        st_sp, pts = mags_to_display(core, st_sp,
                                     np.asarray(out["spectrum_mags"]))
        wf.add_lines(np.tile(pts, (rx.nt, 1)))
        if args.record:
            flat = 0
            for gi, g in enumerate(out["groups"]):
                rows = np.asarray(g["level"]).shape[0]
                if "audio" not in g:
                    flat += rows
                    continue
                audio = np.asarray(g["audio"])
                squelched = np.asarray(g["squelched"])
                for ri in range(rows):
                    key = flat + ri
                    if key not in recorders:
                        recorders[key] = RecordingSink(
                            f"{args.record}_demod{key}", rx.audio_rate,
                            channels=audio.shape[1])
                    recorders[key].write(audio[ri], bool(squelched[ri]))
                flat += rows
        n_blocks += 1
    mix_w.close()
    for r in recorders.values():
        r.close()
    png = args.output.rsplit(".", 1)[0] + "_waterfall.png"
    with open(png, "wb") as f:
        f.write(wf.render_png_bytes())
    if args.checkpoint:
        # Host-side snapshot of the placed (sharded) state tree.
        save_state(args.checkpoint,
                   jax.tree.map(lambda a: np.asarray(a), state),
                   meta={"blocks": n_blocks})
    print(f"sharded rx on {nt}x{nc} mesh: {n_blocks} blocks -> "
          f"{mix_w.current_path}, {png}"
          + (f", checkpoint {args.checkpoint}" if args.checkpoint else ""))
    return 0


def cmd_serve(args):
    """Live receiver + web UI (the AppFrame analog, served over HTTP)."""
    import time
    from cubicsdr.app.runner import LiveReceiver
    from cubicsdr.app.session import SessionMgr
    from cubicsdr.app.webview import WebViewer
    from cubicsdr.io import FileIQSource
    from cubicsdr.io.sources import SyntheticSource, Station
    from cubicsdr.receiver import (
        DemodulatorMgr, ReceiverPipeline, plan_from_manager,
        controls_from_manager)

    from cubicsdr.app.config import AppConfig
    # Persisted app config, loaded at start and saved at exit
    # (ref: AppConfig ctor load + OnExit save, src/CubicSDR.cpp:215,433).
    config = AppConfig.load(name=args.config)
    mgr = DemodulatorMgr()
    center, rate = float(config.center_freq or 100e6), args.rate
    if args.session:
        sess = SessionMgr(mgr)
        if not sess.load_session(args.session):
            print(f"cannot load session {args.session}", file=sys.stderr)
            return 1
        center, rate = sess.center_freq, sess.sample_rate
    if not mgr.get_demodulators():
        mgr.new_demodulator(center + 200e3, "FM", 200000)
    from cubicsdr.io.devices import SDRDeviceInfo
    device_info = SDRDeviceInfo("synthetic=0", "Synthetic Signal Generator",
                                "synthetic")
    src = None
    if args.soapy is not None:
        # Live hardware: "driver=rtlsdr,..." SoapySDR args string. Open the
        # device FIRST — it may renegotiate the rate (ref: SoapySDRThread
        # .cpp:499-513) and the pipeline, channel centers and audio
        # resampling must all be built from the APPLIED rate. Persisted
        # DeviceConfig (ppm/AGC/gains/settings) reapplies on open
        # (ref: src/CubicSDR.cpp:814-841).
        from cubicsdr.io.soapy import SoapySDRSource
        dc = config.get_device(args.soapy)
        src = SoapySDRSource(
            args.soapy, sample_rate=dc.sample_rate or rate,
            frequency=center, ppm=dc.ppm, agc=dc.agc_mode,
            iq_swap=bool(dc.settings.get("iq_swap", False)),
            wire_format=args.wire_format)
        for gname, gval in dc.gains.items():
            src.set_gain(gname, gval)
        for k, v in dc.settings.items():
            if k != "iq_swap":
                src.write_setting(k, v)
        rate = src.sample_rate
    specs, keyed = plan_from_manager(mgr)
    rx = ReceiverPipeline(rate, specs, chan_mode=args.channelizer,
                          dtype=PLANAR)
    controls = controls_from_manager(mgr, rx, keyed, center)
    if src is not None:
        src.set_block_len(rx.block_len)
    elif args.input:
        src = FileIQSource(args.input, rate, rx.block_len, loop=True)
    else:
        src = SyntheticSource(rate, rx.block_len,
                              [Station(200e3, "fm", audio_freq=1000.0),
                               Station(-300e3, "am", audio_freq=600.0)])
    # Native-format ingest: CS16/CS8 wire planes ride the ring and the
    # host->device link at wire width; the compiled step converts on the
    # device's vector units (half/quarter the DMA bytes of CF32).
    import numpy as _np
    ingest = {"cf32": None, "cs16": _np.int16,
              "cs8": _np.int8}[args.wire_format]
    lr = LiveReceiver(rx, controls, src, center_freq=center,
                      record_path=args.record or config.recording_path
                      or None,
                      waterfall_fft=args.fft_size,
                      waterfall_lps=float(config.waterfall_lps or 30),
                      ingest_dtype=ingest)
    try:
        lr.waterfall.set_theme(config.theme)
    except Exception:                      # noqa: BLE001 — unknown theme
        pass
    if args.audio:
        # Host playback of the live mix (RtAudio role,
        # ref: src/audio/AudioThread.cpp:88-243).
        lr.set_audio_output(args.audio)
    viewer = WebViewer(lr, mgr, keyed, host=args.host,
                       port=args.port, device_info=device_info,
                       source=src, config=config).start()
    if args.rig:
        from cubicsdr.app.rig import (RigController, SimulatedRig,
                                      open_hamlib_rig)
        if args.rig == "sim":
            rig = SimulatedRig(center)
        else:                              # "hamlib:<model>:<port>[:baud]"
            parts = args.rig.split(":")
            rig = open_hamlib_rig(int(parts[1]), parts[2],
                                  int(parts[3]) if len(parts) > 3 else 9600)
        viewer.attach_rig(RigController(rig))
    print(f"serving http://{args.host}:{viewer.port}/  "
          f"(center {format_frequency(center)}, rate {rate:.0f})")
    # SIGTERM -> the same ordered drain as Ctrl-C (ref: CubicSDR::OnExit
    # source-first shutdown, src/CubicSDR.cpp:433-528); background shells
    # ignore SIGINT, so daemons get stopped with TERM.
    import signal

    def _term(_sig, _frm):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    lr.start_producer()
    try:
        while True:
            n = lr.run_blocks(max_blocks=64)
            if n == 0:
                time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    finally:
        lr.stop()
        viewer.stop()
        # Auto-save the config on exit (ref: CubicSDR::OnExit saves
        # config.xml, src/CubicSDR.cpp:433-443).
        config.center_freq = int(lr.center_freq)
        config.theme = lr.waterfall.theme_name
        config.waterfall_lps = int(lr.dist.lps)
        config.save(name=args.config)
        print(lr.status())


def cmd_multihost(args):
    """Distributed multi-process receive (SURVEY §2.11 DCN ingest scatter).

    Launcher mode (default): spawn N local CPU worker processes — the
    loopback stand-in for an N-host DCN job. Worker mode (--worker): join
    the job as one process; on a real pod run one worker per host with
    --coordinator pointing at host 0."""
    from cubicsdr.parallel import multihost
    if args.worker:
        rep = multihost.run_worker(args.coordinator, args.nprocs,
                                   args.process_id, steps=args.steps,
                                   verify=not args.no_verify,
                                   timed_steps=args.timed_steps)
        print(json.dumps(rep))
        return 0
    reports = multihost.launch_local(args.nprocs, steps=args.steps,
                                     devices_per_process=args.devices,
                                     timed_steps=args.timed_steps)
    for rep in reports:
        print(json.dumps(rep))
    ok = all(r["ok"] and r["process_count"] == args.nprocs
             for r in reports)
    print(f"multihost: {args.nprocs} processes x "
          f"{reports[0]['local_devices']} devices, "
          f"{args.steps} verified steps -> {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


def cmd_modems(args):
    from cubicsdr.modems import modem_names, make_modem
    for t in ("analog", "digital"):
        names = modem_names(t)
        if not names:
            continue
        print(f"{t}:")
        for n in names:
            m = make_modem(n)
            settings = {a.key: a.value for a in m.get_settings()}
            extra = f"  settings={settings}" if settings else ""
            print(f"  {n:6s} default_rate={m.default_sample_rate}{extra}")


def cmd_bench(args):
    import runpy
    import os
    sys.argv = ["bench.py"]
    runpy.run_path(os.path.join(os.path.dirname(__file__),
                                "..", "..", "bench.py"),
                   run_name="__main__")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="cubicsdr",
        description="JAX software radio (CubicSDR capability set)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demod", help="demodulate one station from a capture")
    d.add_argument("input")
    d.add_argument("-r", "--rate", type=float, required=True)
    d.add_argument("-c", "--center", default="0",
                   help="capture center frequency")
    d.add_argument("-f", "--frequency", required=True,
                   help="station frequency (abs, or offset if center=0)")
    d.add_argument("-m", "--modem", default="FM")
    d.add_argument("-b", "--bandwidth", type=float, default=200000)
    d.add_argument("-o", "--output", default="audio.wav")
    d.add_argument("--squelch", type=float, default=None)
    d.add_argument("--channelizer", default="pfbch2",
                   choices=["pfbch", "pfbch2", "single"])
    d.add_argument("--max-seconds", type=float, default=0)
    d.set_defaults(fn=cmd_demod)

    w = sub.add_parser("waterfall", help="render a waterfall PNG")
    w.add_argument("input")
    w.add_argument("-r", "--rate", type=float, required=True)
    w.add_argument("-o", "--output", default="waterfall.png")
    w.add_argument("--fft-size", type=int, default=2048)
    w.add_argument("--lines", type=int, default=512)
    w.add_argument("--lps", type=float, default=30)
    w.add_argument("--theme", default="default")
    w.set_defaults(fn=cmd_waterfall)

    r = sub.add_parser("rx", help="run a saved session against a capture")
    r.add_argument("session")
    r.add_argument("input")
    r.add_argument("-o", "--output", default="mix.wav")
    r.add_argument("--channelizer", default="pfbch2",
                   choices=["pfbch", "pfbch2", "single"])
    r.add_argument("--play", nargs="?", const="auto", default=None,
                   help="also play the mix to a host audio backend "
                        "(auto|sounddevice|wav:<path>|null)")
    r.add_argument("--mesh", default=None,
                   help='run on a device mesh, e.g. "time=4,chan=2" '
                        "(sharded receiver: halo channelizer, psum mix, "
                        "all-gather spectrum waterfall)")
    r.add_argument("--fft-size", type=int, default=512,
                   help="waterfall FFT size (sharded mode)")
    r.add_argument("--checkpoint", default=None,
                   help="state snapshot path: resumed if present, saved "
                        "at end (bit-continuous, sharded mode)")
    r.add_argument("--record", default=None,
                   help="base path for per-demod recording WAVs "
                        "(sharded mode)")
    r.set_defaults(fn=cmd_rx)

    s = sub.add_parser("serve", help="live receiver with web UI")
    s.add_argument("--wire-format", choices=["cf32", "cs16", "cs8"],
                   default="cf32",
                   help="ingest sample format: native CS16/CS8 halves/"
                        "quarters host->device bytes (on-device convert)")
    s.add_argument("session", nargs="?", default=None,
                   help="session .json (optional)")
    s.add_argument("input", nargs="?", default=None,
                   help="IQ capture to loop (default: synthetic stations)")
    s.add_argument("-r", "--rate", type=float, default=2_400_000)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("-p", "--port", type=int, default=8080)
    s.add_argument("--fft-size", type=int, default=1024)
    s.add_argument("--soapy", default=None,
                   help='live SoapySDR device args, e.g. "driver=rtlsdr"')
    s.add_argument("--rig", default=None,
                   help='rig control: "sim" or "hamlib:<model>:<port>[:baud]"')
    s.add_argument("--record", default=None,
                   help="base path to record per-demod WAVs")
    s.add_argument("--audio", nargs="?", const="auto", default=None,
                   help="play the live mix to a host audio backend "
                        "(auto|sounddevice|wav:<path>|null)")
    s.add_argument("-c", "--config", default="",
                   help="named config (ref: CubicSDR -c flag); loaded at "
                        "start, auto-saved at exit")
    s.add_argument("--channelizer", default="pfbch2",
                   choices=["pfbch", "pfbch2", "single"])
    s.set_defaults(fn=cmd_serve)

    mh = sub.add_parser("multihost",
                        help="distributed multi-process receive (DCN)")
    mh.add_argument("--nprocs", type=int, default=2)
    mh.add_argument("--steps", type=int, default=2)
    mh.add_argument("--devices", type=int, default=4,
                    help="CPU devices per process (launcher mode)")
    mh.add_argument("--worker", action="store_true")
    mh.add_argument("--coordinator", default="localhost:9876")
    mh.add_argument("--process-id", type=int, default=0)
    mh.add_argument("--no-verify", action="store_true")
    mh.add_argument("--timed-steps", type=int, default=0,
                    help="append a steady-state timing phase of N steps "
                         "(reports aggregate MS/s + ingest-scatter share)")
    mh.set_defaults(fn=cmd_multihost)

    m = sub.add_parser("modems", help="list modem types")
    m.set_defaults(fn=cmd_modems)

    b = sub.add_parser("bench", help="run the throughput benchmark")
    b.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    enable_compile_cache()
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
