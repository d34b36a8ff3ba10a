"""ShardedReceiver — the multi-chip receive pipeline.

Shards the unified ReceiverPipeline chain (wideband channelize -> routed
mixed-modem demod farm -> squelch -> mix) over a ('time', 'chan') mesh in
the PLANAR representation (the one the single-device pipeline runs):

  * 'time': the IQ block is split into contiguous slices per device. Every
    FIR-like stage consumes (history, samples); the history is the previous
    shard's tail via one cyclic ppermute per stage (parallel/halo.py +
    the StreamOp time-sharding protocol, stream/op.py). The cyclic wrap
    carries streaming state across blocks for free. NCO phase continuity is
    closed-form: a carried per-demod phase base plus omega * t_idx * L_local.
    Block-statistic stages (AGC, carrier EMAs, squelch meters) keep
    replicated state via pmean/pmax collectives; the channel-0 DC blocker
    composes its IIR recurrence exactly across shards (ops/iir.py).
  * 'chan': demodulator rows are split across devices (embarrassingly
    parallel); the final mix is a psum over 'chan'.

This maps the reference's axes onto a device mesh (SURVEY.md §2.11): its
thread pipeline becomes 'time', its per-demod threads become 'chan', and the
in-process queues become collectives between devices. The demod math itself
is the SAME
modem-kit objects the single-chip pipeline runs — sharding is a driver, not
a reimplementation.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cubicsdr.modems import make_modem
from cubicsdr.ops.channelizer import ChannelizerPFB2, channel_centers
from cubicsdr.ops.iir import DCBlocker
from cubicsdr.ops.planar import PC, PLANAR, from_complex, pc_take
from cubicsdr.parallel.mesh import make_receiver_mesh
from cubicsdr.receiver.frontend import ChannelFrontend, shift_omegas
from cubicsdr.receiver.pipeline import DemodGroupSpec
from cubicsdr.receiver.squelch import SquelchGate

TWO_PI = 2.0 * np.pi


def _add_time(tree):
    return jax.tree.map(lambda a: a[None], tree)


def _strip_time(tree):
    return jax.tree.map(lambda a: a[0], tree)


class ShardedReceiver:
    """Fixed-plan mixed-modem farm: M-channel PFBCH2 + heterogeneous demod
    groups, planar representation, squelch + controls in-graph.

    groups: list[DemodGroupSpec]; every group's count must divide the mesh's
    'chan' extent. ``block_len`` is GLOBAL samples per step (must split into
    n_time equal shards, each a multiple of the per-shard block multiple).
    Legacy FM-farm shorthand: pass ``n_demods=`` instead of groups.
    """

    def __init__(self, sample_rate: float, num_channels: int,
                 groups: list[DemodGroupSpec] | None = None,
                 n_demods: int | None = None,
                 mesh: jax.sharding.Mesh | None = None,
                 bandwidth: float = 200_000.0, audio_rate: int = 48_000,
                 block_len: int | None = None,
                 spectrum_fft: int | None = None):
        # spectrum_fft: full-band spectrum tap — each time shard computes
        # the |FFT| of its newest fftSizeInternal window and the frames are
        # assembled across shards with an all-gather (SURVEY §2.11
        # "all-gather spectrum assembly"); feed the result to the display
        # EMA (visual/spectrum.frame_update) on the host or a viz chip.
        self.spectrum_fft = spectrum_fft
        self.mesh = mesh if mesh is not None else make_receiver_mesh()
        self.nt = self.mesh.shape["time"]
        self.nc = self.mesh.shape["chan"]
        if groups is None:
            assert n_demods is not None
            groups = [DemodGroupSpec("FM", int(bandwidth), n_demods)]
        self.groups = list(groups)
        self.n_demods = sum(g.count for g in groups)
        self.sample_rate = float(sample_rate)
        self.M = int(num_channels)
        self.audio_rate = audio_rate

        self.chan = ChannelizerPFB2(self.M, dtype=PLANAR)
        self.D = self.M // 2
        self.chan_rate = 2.0 * sample_rate / self.M
        self.dc = DCBlocker(0.0005, dtype=PLANAR)
        self.centers_np = channel_centers(self.M, sample_rate)

        # Per-group ops — the SAME classes ReceiverPipeline builds, with
        # local (per-'chan'-device) batch rows and time_axis collectives.
        self._modems, self.frontends, self.kits, self.gates = [], [], [], []
        self.is_digital, self.n_locals = [], []
        import math
        m = 2 * self.D              # even steps per shard (PFBCH2 parity)
        for g in self.groups:
            assert g.count % self.nc == 0, (
                f"group {g.modem_name} count {g.count} must divide the "
                f"'chan' mesh extent {self.nc}")
            n_local = g.count // self.nc
            modem = make_modem(g.modem_name, **g.settings_dict)
            bw = modem.check_sample_rate(g.bandwidth, audio_rate)
            digital = modem.modem_type == "digital"
            fe = ChannelFrontend(self.chan_rate, bw, n_local, dtype=PLANAR)
            kit = modem.build_kit(bw, audio_rate, batch_shape=(n_local,),
                                  dtype=PLANAR, time_axis="time")
            gate = (SquelchGate(bw, n_local, time_axis="time") if digital
                    else SquelchGate(audio_rate, n_local,
                                     use_signal_out=[
                                         modem.uses_signal_output()]
                                     * n_local, time_axis="time"))
            # Global-batch twins: carry arrays passed to shard_map are
            # GLOBAL-shaped ([count] demod axis, sharded over 'chan').
            fe_g = ChannelFrontend(self.chan_rate, bw, g.count, dtype=PLANAR)
            kit_g = modem.build_kit(bw, audio_rate, batch_shape=(g.count,),
                                    dtype=PLANAR, time_axis="time")
            gate_g = (SquelchGate(bw, g.count, time_axis="time") if digital
                      else SquelchGate(audio_rate, g.count,
                                       use_signal_out=[
                                           modem.uses_signal_output()]
                                       * g.count, time_axis="time"))
            self._init_ops = getattr(self, "_init_ops", [])
            self._init_ops.append((fe_g, kit_g, gate_g))
            self._modems.append(modem)
            self.frontends.append(fe)
            self.kits.append(kit)
            self.gates.append(gate)
            self.is_digital.append(digital)
            self.n_locals.append(n_local)
            b_k = modem.block_multiple(int(bw), audio_rate)
            t = b_k // math.gcd(fe.P, b_k)
            m = math.lcm(m, self.D * fe.Q * t)

        self.local_multiple = m
        if block_len is None:
            per_shard = max(m, ((1 << 17) // m) * m)
        else:
            assert block_len % (self.nt * m) == 0, (block_len, self.nt, m)
            per_shard = block_len // self.nt
        self.local_len = per_shard
        self.block_len = per_shard * self.nt
        self.local_chan_len = self.local_len // self.D
        assert self.local_chan_len % 2 == 0
        # Audio lengths must agree across analog groups (mix concatenation).
        outs = set()
        for gi, fe in enumerate(self.frontends):
            if self.is_digital[gi]:
                continue
            from cubicsdr.ops.resample import design_ratio
            P2, Q2 = design_ratio(self.audio_rate / fe.bandwidth, 500)
            d_len = fe.out_len(self.local_chan_len)
            outs.add(d_len if self._modems[gi].name == "I/Q"
                     else d_len // Q2 * P2)
        assert len(outs) <= 1, f"audio length mismatch: {outs}"
        self.local_audio_len = outs.pop() if outs else 0

    # --- carried state: everything stored with a leading [nt] axis and
    # sharded P('time', ...); replicated leaves (EMAs, phase bases) hold
    # identical values on every time shard by construction. ---
    def init_state(self):
        def rep(tree):
            return jax.tree.map(
                lambda a: jnp.broadcast_to(a[None], (self.nt, *a.shape)),
                tree)
        return {
            "chan": rep(self.chan.shard_carry_init()),
            "dc": rep(self.dc.shard_carries()),
            "groups": tuple(
                (rep(fe_g.shard_carries()), rep(kit_g.shard_carries()),
                 rep(gate_g.init_state()))
                for fe_g, kit_g, gate_g in self._init_ops),
        }

    def state_specs(self):
        def spec(tree, s):
            return jax.tree.map(lambda _: s, tree)
        st = self.init_state()
        return {
            "chan": spec(st["chan"], P("time")),
            "dc": spec(st["dc"], P("time")),
            "groups": tuple(
                (spec(fe_c, P("time", "chan")),
                 spec(kit_c, P("time", "chan")),
                 spec(gate_c, P("time", "chan")))
                for fe_c, kit_c, gate_c in st["groups"]),
        }

    def control_template(self):
        out = []
        for g in self.groups:
            n = g.count
            out.append({
                "frequency": np.zeros(n, np.float32),
                "squelch_level": np.full(n, -100.0, np.float32),
                "squelch_enabled": np.zeros(n, bool),
                "gain": np.ones(n, np.float32),
                "active": np.ones(n, bool),
            })
        return out

    def _control_specs(self):
        return [
            {k: P("chan") for k in ctl} for ctl in self.control_template()]

    def _out_specs(self):
        gspecs = []
        for dig in self.is_digital:
            if dig:
                gspecs.append({"symbols": P("chan", "time"),
                               "evm": P("chan"), "locked": P("chan"),
                               "level": P("chan"), "floor": P("chan"),
                               "ceil": P("chan"), "squelched": P("chan")})
            else:
                gspecs.append({"audio": P("chan", None, "time"),
                               "level": P("chan"), "floor": P("chan"),
                               "ceil": P("chan"), "squelched": P("chan"),
                               "peak": P("chan")})
        out = {"mix": P(None, "time"), "mix_peak": P(),
               "groups": gspecs}
        if self.spectrum_fft:
            out["spectrum_mags"] = P()     # all-gathered -> replicated
        return out

    def _shard_body(self, state, iq_local, controls):
        """Runs per-device inside shard_map. iq_local: PC [local_len];
        controls: per-group dicts of [n_local] vectors."""
        centers = jnp.asarray(self.centers_np, jnp.float32)

        # ---- channelize (tail halo; parity shard-invariant) ----
        c_chan, chans = self.chan.shard_apply(
            _strip_time(state["chan"]), iq_local, "time")
        # ---- DC-block channel 0 (exact cross-shard IIR) ----
        c_dc, ch0 = self.dc.shard_apply(
            _strip_time(state["dc"]),
            PC(chans.re[..., 0, :], chans.im[..., 0, :]), "time")
        chans = PC(chans.re.at[..., 0, :].set(ch0.re),
                   chans.im.at[..., 0, :].set(ch0.im))

        new_groups, group_outs = [], []
        audio_all, peaks_all, gains_all, act_all = [], [], [], []
        for gi, (fe, kit, gate) in enumerate(
                zip(self.frontends, self.kits, self.gates)):
            c_fe, c_kit, s_gate = map(_strip_time, state["groups"][gi])
            ctl = controls[gi]
            freqs = jnp.asarray(ctl["frequency"], jnp.float32)
            dist = jnp.abs(freqs[:, None] - centers[None, :])
            ci = jnp.argmin(dist, axis=-1)
            omega = shift_omegas(freqs, centers[ci], self.chan_rate)
            x = pc_take(chans, ci, axis=-2)              # [n_local, Lc]
            c_fe, y = fe.shard_apply(c_fe, (x, omega), "time")
            c_kit, ko = kit.shard_apply(c_kit, y, "time")
            if self.is_digital[gi]:
                s_gate, gout = gate.apply(
                    s_gate, (None, y, ctl["squelch_level"],
                             ctl["squelch_enabled"]))
                # evm/locked are per-time-segment; report block-global.
                evm = jax.lax.pmean(ko["evm"], "time")
                gout["symbols"] = ko["symbols"]
                gout["evm"] = evm
                gout["locked"] = jax.lax.pmean(
                    ko["locked"].astype(jnp.float32), "time") > 0.5
            else:
                s_gate, gout = gate.apply(
                    s_gate, (ko, y, ctl["squelch_level"],
                             ctl["squelch_enabled"]))
                a = gout["audio"]
                if a.shape[-2] == 1:
                    a = jnp.concatenate([a, a], axis=-2)
                audio_all.append(a)
                peaks_all.append(gout["peak"])
                gains_all.append(jnp.asarray(ctl["gain"], jnp.float32))
                act_all.append(jnp.asarray(ctl["active"], jnp.float32))
            new_groups.append(tuple(map(_add_time, (c_fe, c_kit, s_gate))))
            group_outs.append(gout)

        # ---- mix: local weighted sum, psum over 'chan'; peak statistics
        # match the unsharded mixer (per-stream pmax over time, then the
        # gain-weighted sum over ALL streams). ----
        if audio_all:
            a_cat = jnp.concatenate(audio_all, axis=-3)
            g_cat = (jnp.concatenate(gains_all, axis=-1)
                     * jnp.concatenate(act_all, axis=-1))
            p_cat = jnp.concatenate(peaks_all, axis=-1)   # pmax'd in gate
            mix = jax.lax.psum(
                jnp.sum(a_cat * g_cat[:, None, None], axis=-3), "chan")
            peak = jax.lax.psum(jnp.sum(p_cat * g_cat, axis=-1), "chan")
            scale = jnp.where(peak > 1.0, 1.0 / jnp.maximum(peak, 1e-9),
                              1.0)
            mix = mix * scale
            mix_peak = jnp.minimum(peak, 1.0)
        else:
            mix = jnp.zeros((2, self.local_audio_len), jnp.float32)
            mix_peak = jnp.zeros((), jnp.float32)

        new_state = {"chan": _add_time(c_chan), "dc": _add_time(c_dc),
                     "groups": tuple(new_groups)}
        outs = {"mix": mix, "mix_peak": mix_peak, "groups": group_outs}

        # ---- spectrum assembly: one |FFT| frame per time shard, gathered
        # in shard order over the 'time' axis (all-gather) ----
        if self.spectrum_fft:
            from cubicsdr.ops.planar import pc_fft_four_step
            n = self.spectrum_fft * 2            # fftSizeInternal (VZM)
            assert self.local_len >= n, (self.local_len, n)
            win = iq_local.slice_last(slice(self.local_len - n, None))
            n1 = 1 << (int(np.log2(n)) // 2)
            while n % n1:
                n1 >>= 1
            X = pc_fft_four_step(win, n1, n // n1)
            mag = jnp.roll(jnp.sqrt(X.re * X.re + X.im * X.im),
                           n // 2, axis=-1)
            outs["spectrum_mags"] = jax.lax.all_gather(mag, "time")

        return new_state, outs

    def make_step(self):
        """Returns jitted step(state, iq PC[block_len], controls) ->
        (state, outs) with outs like ReceiverPipeline's (audio concatenated
        across time shards; levels/flags replicated-global)."""
        fn = jax.shard_map(
            self._shard_body, mesh=self.mesh,
            in_specs=(self.state_specs(), P("time"),
                      self._control_specs()),
            out_specs=(self.state_specs(),
                       self._out_specs()),
            check_vma=False,
        )
        return jax.jit(fn, donate_argnums=(0,))

    def place_state(self, state):
        specs = self.state_specs()
        sh = jax.tree.map(
            lambda s: jax.sharding.NamedSharding(self.mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P))
        return jax.tree.map(
            lambda a, s: jax.device_put(a, s), state,
            jax.tree.map(lambda s: s, sh,
                         is_leaf=lambda x: isinstance(
                             x, jax.sharding.NamedSharding)))

    # --- convenience: sharded input placement ---
    def shard_iq(self, iq):
        """iq: complex ndarray or PC of [block_len] -> PC placed P('time')."""
        if not isinstance(iq, PC):
            iq = from_complex(np.asarray(iq))
        sh = jax.sharding.NamedSharding(self.mesh, P("time"))
        return PC(jax.device_put(iq.re, sh), jax.device_put(iq.im, sh))

    def shard_iq_local(self, local_planes: np.ndarray):
        """Multi-host DCN ingest scatter (SURVEY §2.11): each host supplies
        ONLY its own time-shard of the block as float32 planes
        [2, block_len // n_processes] (its local SDR/socket sources feed
        just that span), and the global sharded array is assembled without
        gathering samples on any single host —
        ``jax.make_array_from_process_local_data`` maps each process's
        planes onto its local devices; DCN then carries only the compiled
        step's collectives, never raw IQ.

        Single-process (tests, one host): local == global and this is
        equivalent to ``shard_iq``.
        """
        local_planes = np.ascontiguousarray(local_planes, np.float32)
        n_proc = jax.process_count()
        expect = self.block_len // n_proc
        assert local_planes.shape == (2, expect), (
            f"host shard must be [2, {expect}], got {local_planes.shape}")
        sh = jax.sharding.NamedSharding(self.mesh, P("time"))
        re = jax.make_array_from_process_local_data(
            sh, local_planes[0], global_shape=(self.block_len,))
        im = jax.make_array_from_process_local_data(
            sh, local_planes[1], global_shape=(self.block_len,))
        return PC(re, im)

    def place_controls(self, controls):
        sh = jax.sharding.NamedSharding(self.mesh, P("chan"))
        return [
            {k: jax.device_put(jnp.asarray(v), sh) for k, v in ctl.items()}
            for ctl in controls]
