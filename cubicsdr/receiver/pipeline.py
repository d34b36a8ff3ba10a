"""ReceiverPipeline — the whole receive chain as ONE compiled step.

The reference's streaming hot path (SURVEY.md §3.2) is a chain of threads:
SDRPostThread channelizes and routes per-demod buffers
(ref: src/sdr/SDRPostThread.cpp:303-396), each demod runs PreThread (NCO +
resample) -> DemodulatorThread (modem + squelch) -> AudioThread (mix).
Here the entire graph for a fixed *plan* (set of demod groups) compiles to
one XLA program per block:

    iq[L] -> PFBCH/PFBCH2/single -> gather channels[N] -> batched NCO+resample
          -> batched modem kits -> squelch/level -> per-group audio
          -> stereo upmix -> gain/mute/solo mix -> (mix, per-demod outputs)

Retunes, squelch levels, gains, mutes: traced inputs (no recompile).
Add/remove/retype demods: host rebuilds the plan (the reference rebuilds
kits on a worker thread for the same reason, ref: DemodulatorWorkerThread
.cpp:54-109).

Representation: ``dtype=jnp.complex64`` (CPU tests) or
``dtype=ops.planar.PLANAR`` — two float32 planes, the representation the
application runs. ONE pipeline class serves both: all stages are
planes-first, so the planar program is the same math compiled on real
arrays.

Digital demod groups (modem_type == "digital") ride the same chain: their
kits emit symbol streams instead of audio (ref: ModemDigital.cpp:56-83),
the signal meter runs on their channel IQ, and they contribute nothing to
the audio mix (matching the reference, where digital modems never push to
the audio queue — src/demod/DemodulatorThread.cpp:237-247 guards on
modemType).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.io.sources import optimal_channel_count
from cubicsdr.modems import make_modem
from cubicsdr.ops.channelizer import (
    ChannelizerPFB, ChannelizerPFB2, channel_centers)
from cubicsdr.ops.iir import DCBlocker
from cubicsdr.ops.planar import PC, pc_take
from cubicsdr.receiver.frontend import ChannelFrontend, shift_omegas
from cubicsdr.receiver.mixer import mix_audio
from cubicsdr.receiver.squelch import SquelchGate
from cubicsdr.stream.op import StreamOp


@dataclass(frozen=True)
class DemodGroupSpec:
    """A batch of demodulators sharing one modem type/bandwidth (one row set
    of the compiled program)."""
    modem_name: str
    bandwidth: int
    count: int
    settings: tuple = ()          # modem settings as sorted (k, v) pairs

    @property
    def settings_dict(self):
        return dict(self.settings)


class ReceiverPipeline(StreamOp):
    """Fixed-plan compiled receiver.

    chan_mode: 'pfbch' | 'pfbch2' | 'single'
      (ref modes: SDRPostThreadChannelizerType, src/sdr/SDRPostThread.h:25-27;
      'single' is the numChannels==1 DC-blocked passthrough,
      ref: SDRPostThread.cpp:248-301).
    """

    def __init__(self, sample_rate: float, groups: list[DemodGroupSpec],
                 chan_mode: str = "pfbch2", num_channels: int | None = None,
                 audio_rate: int = 48000, block_len: int | None = None,
                 dtype=jnp.complex64):
        self.sample_rate = float(sample_rate)
        self.audio_rate = int(audio_rate)
        self.chan_mode = chan_mode
        self.groups = list(groups)
        self.dtype = dtype
        # Remember whether the caller pinned block_len (plan rebuilds
        # forward an explicit choice; a default one is re-derived).
        self.block_len_explicit = block_len is not None
        if chan_mode == "single":
            self.M = 1
            self.chan_rate = self.sample_rate
        else:
            self.M = num_channels or optimal_channel_count(sample_rate)
            chan_bw = self.sample_rate / self.M
            self.chan_rate = chan_bw * (2 if chan_mode == "pfbch2" else 1)

        # Build per-group ops.
        self._modems = []
        self.frontends = []
        self.kits = []
        self.gates = []
        self.is_digital = []
        for g in self.groups:
            modem = make_modem(g.modem_name, **g.settings_dict)
            bw = modem.check_sample_rate(g.bandwidth, audio_rate)
            digital = modem.modem_type == "digital"
            fe = ChannelFrontend(self.chan_rate, bw, g.count, dtype=dtype)
            kit = modem.build_kit(bw, audio_rate, batch_shape=(g.count,),
                                  dtype=dtype)
            if digital:
                # Signal meter runs on the bandwidth-rate IQ; symbol modems
                # have no audio to gate.
                gate = SquelchGate(bw, g.count)
            else:
                gate = SquelchGate(audio_rate, g.count,
                                   use_signal_out=[modem.uses_signal_output()]
                                   * g.count)
            self._modems.append(modem)
            self.frontends.append(fe)
            self.kits.append(kit)
            self.gates.append(gate)
            self.is_digital.append(digital)

        # Channelizer + DC blocker (channel 0 carries the tuner DC spike,
        # ref: SDRPostThread.cpp:364-375).
        if chan_mode == "pfbch":
            self.channelizer = ChannelizerPFB(self.M, dtype=dtype)
            self._decim = self.M
        elif chan_mode == "pfbch2":
            self.channelizer = ChannelizerPFB2(self.M, dtype=dtype)
            self._decim = self.M // 2
        else:
            self.channelizer = None
            self._decim = 1
        self.dc = DCBlocker(0.0005, dtype=dtype)

        self.block_len = block_len or self.choose_block_len()
        self._check_lengths()

    # --- static shape bookkeeping ---
    def group_block_multiple(self, gi: int) -> int:
        fe = self.frontends[gi]
        modem = self._modems[gi]
        bw = fe.bandwidth
        b_k = modem.block_multiple(int(bw), self.audio_rate)
        t = b_k // math.gcd(fe.P, b_k)
        return self._decim * fe.Q * t

    def choose_block_len(self, target_batches_per_sec: int = 60) -> int:
        m = self._decim if self.chan_mode != "single" else 1
        if self.chan_mode == "pfbch":
            m = self.M
        for gi in range(len(self.groups)):
            m = math.lcm(m, self.group_block_multiple(gi))
        n = int(self.sample_rate / target_batches_per_sec)
        return max(((n + m - 1) // m) * m, m)

    def _check_lengths(self):
        L = self.block_len
        # Per-channel samples per block: L/decim for both modes (decim is
        # M for pfbch, M/2 for pfbch2 — the 2x oversampling is already in
        # the smaller decimation), L for single-channel.
        lc = L // self._decim
        self._chan_len = lc
        outs = set()
        for fe in self.frontends:
            assert lc % fe.Q == 0, (
                f"block_len {L} -> channel len {lc} not divisible by "
                f"frontend Q={fe.Q}; use choose_block_len()")
        # Audio lengths must agree across (analog) groups for mixing.
        for gi, fe in enumerate(self.frontends):
            if self.is_digital[gi]:
                continue
            o1 = fe.out_len(lc)
            la = self._kit_out_len(gi, o1)
            outs.add(la)
        assert len(outs) <= 1, (
            f"groups produce different audio lengths {outs}: bandwidth/audio "
            f"ratios must be exact rationals")
        self.audio_len = outs.pop() if outs else 0

    def _kit_out_len(self, gi, in_len):
        # All analog kits resample bandwidth -> audio_rate with exact
        # rationals.
        from cubicsdr.ops.resample import design_ratio
        fe = self.frontends[gi]
        P, Q = design_ratio(self.audio_rate / fe.bandwidth,
                            max_denominator=500)
        if self._modems[gi].name == "I/Q":
            return in_len
        return in_len // Q * P

    # --- state ---
    def init_state(self):
        return {
            "chan": (self.channelizer.init_state()
                     if self.channelizer else ()),
            "dc": self.dc.init_state(),
            "groups": tuple(
                (fe.init_state(), kit.init_state(), gate.init_state())
                for fe, kit, gate in
                zip(self.frontends, self.kits, self.gates)),
        }

    # --- control vector layout: per-demod traced params, grouped ---
    def control_template(self):
        """Per-group dict arrays the caller fills each step (all traced)."""
        out = []
        for g in self.groups:
            n = g.count
            out.append({
                "frequency": np.zeros(n, np.float32),   # offset from center Hz
                "squelch_level": np.full(n, -100.0, np.float32),
                "squelch_enabled": np.zeros(n, bool),
                "gain": np.ones(n, np.float32),
                "active": np.ones(n, bool),             # mute/solo resolved
            })
        return out

    def apply(self, state, inputs):
        """inputs = (iq[..., L], controls list-of-dicts). Returns
        (state, outputs) with outputs:
          mix[..., 2, La], mix_peak, per-group dicts (analog: audio, level,
          floor, ceil, peak, squelched; digital: symbols, evm, locked,
          level, floor, ceil, squelched), iq passthrough for visual taps."""
        iq, controls = inputs
        st_chan = state["chan"]
        st_dc = state["dc"]
        planar = isinstance(iq, PC)

        if self.channelizer is not None:
            st_chan, chans = self.channelizer.apply(st_chan, iq)
            # DC-block channel 0 (tuner spike).
            st_dc, ch0 = self.dc.apply(st_dc, chans[..., 0, :])
            if planar:
                chans = PC(chans.re.at[..., 0, :].set(ch0.re),
                           chans.im.at[..., 0, :].set(ch0.im))
            else:
                chans = chans.at[..., 0, :].set(ch0)
            centers = jnp.asarray(
                channel_centers(self.M, self.sample_rate), jnp.float32)
        else:
            st_dc, dcq = self.dc.apply(st_dc, iq)
            chans = (PC(dcq.re[..., None, :], dcq.im[..., None, :])
                     if planar else dcq[..., None, :])
            centers = jnp.zeros((1,), jnp.float32)

        group_states = []
        group_outs = []
        audio_all = []
        peaks_all = []
        gains_all = []
        active_all = []
        for gi, (fe, kit, gate) in enumerate(
                zip(self.frontends, self.kits, self.gates)):
            s_fe, s_kit, s_gate = state["groups"][gi]
            ctl = controls[gi]
            freqs = jnp.asarray(ctl["frequency"], jnp.float32)
            # Route each demod to its nearest channel (in-graph so retune
            # does not recompile; ref: SDRPostThread::getChannelAt,
            # src/sdr/SDRPostThread.cpp:128-139).
            dist = jnp.abs(freqs[:, None] - centers[None, :])
            chan_idx = jnp.argmin(dist, axis=-1)
            omega = shift_omegas(freqs, centers[chan_idx], self.chan_rate)
            x = (pc_take(chans, chan_idx, axis=-2) if planar
                 else jnp.take(chans, chan_idx, axis=-2))  # [.., N, Lc]
            s_fe, y = fe.apply(s_fe, (x, omega))
            s_kit, ko = kit.apply(s_kit, y)
            if self.is_digital[gi]:
                # Symbol modem: no audio; meter the channel IQ
                # (ref: DemodulatorThread.cpp:142-196 still levels IQ).
                s_gate, gout = gate.apply(
                    s_gate, (None, y, ctl["squelch_level"],
                             ctl["squelch_enabled"]))
                gout.update(ko)        # symbols / evm / locked
            else:
                s_gate, gout = gate.apply(
                    s_gate, (ko, y, ctl["squelch_level"],
                             ctl["squelch_enabled"]))
                a = gout["audio"]
                if a.shape[-2] == 1:                        # mono -> stereo
                    a = jnp.concatenate([a, a], axis=-2)
                audio_all.append(a)
                peaks_all.append(gout["peak"])
                gains_all.append(jnp.asarray(ctl["gain"], jnp.float32))
                active_all.append(jnp.asarray(ctl["active"], jnp.float32))
            # Per-demod IQ tap (the IQActiveDemodVisualDataOutput analog,
            # ref: SDRPostThread.cpp:233-245) for demod spectrum/scope views.
            gout["iq"] = y
            group_states.append((s_fe, s_kit, s_gate))
            group_outs.append(gout)

        if audio_all:
            audio_cat = jnp.concatenate(audio_all, axis=-3)
            peaks_cat = jnp.concatenate(peaks_all, axis=-1)
            gains_cat = jnp.concatenate(gains_all, axis=-1)
            act_cat = jnp.concatenate(active_all, axis=-1)
            mix, mix_peak = mix_audio(audio_cat, gains_cat, act_cat,
                                      peaks_cat)
        else:
            mix = jnp.zeros((2, self.audio_len), jnp.float32)
            mix_peak = jnp.zeros((), jnp.float32)

        new_state = {"chan": st_chan, "dc": st_dc,
                     "groups": tuple(group_states)}
        return new_state, {
            "mix": mix, "mix_peak": mix_peak,
            "groups": group_outs, "iq": iq,
        }


def plan_from_manager(mgr, audio_rate: int = 48000) -> list[DemodGroupSpec]:
    """Group a DemodulatorMgr's demods into batched specs (type+bandwidth+
    settings share one compiled row-set); returns specs in mgr order groups.
    """
    keyed: dict = {}
    for d in mgr.get_demodulators():
        key = (d.demod_type, int(d.bandwidth),
               tuple(sorted(d.read_modem_settings().items())))
        keyed.setdefault(key, []).append(d)
    return [DemodGroupSpec(k[0], k[1], len(v), k[2])
            for k, v in keyed.items()], keyed


def controls_from_manager(mgr, pipeline: ReceiverPipeline, keyed: dict,
                          center_freq: float):
    """Fill the pipeline's control vectors from live instance properties
    (solo/mute resolution per ref: DemodulatorThread solo squelch-lock +
    AudioThread mute semantics)."""
    any_solo = any(d.solo for d in mgr.get_demodulators())
    half = pipeline.sample_rate / 2
    controls = []
    for (key, demods), g in zip(keyed.items(), pipeline.groups):
        n = len(demods)
        # Range (de)activation: demods outside the captured band go silent
        # (ref: SDRPostThread::updateActiveDemodulators,
        # src/sdr/SDRPostThread.cpp:66-89).
        in_range = [abs(d.frequency - center_freq) <= half for d in demods]
        ctl = {
            "frequency": np.asarray(
                [d.frequency - center_freq for d in demods], np.float32),
            "squelch_level": np.asarray(
                [d.squelch_level for d in demods], np.float32),
            "squelch_enabled": np.asarray(
                [d.squelch_enabled for d in demods], bool),
            "gain": np.asarray([d.gain for d in demods], np.float32),
            "active": np.asarray(
                [ir and not d.muted and (d.solo or not any_solo)
                 for d, ir in zip(demods, in_range)], bool),
        }
        controls.append(ctl)
    return controls
