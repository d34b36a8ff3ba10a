"""The route stage (channel gather + NCO + rational resample) on the plain
XLA path every backend runs: retunes mid-stream, the sharded receiver at
the 2.4 MS/s / six-channel shape, and plan-rebuild state carry."""

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.ops.planar import PC, PLANAR, from_complex
from cubicsdr.receiver import (DemodGroupSpec, DemodulatorMgr,
                               ReceiverPipeline, controls_from_manager,
                               plan_from_manager)


def _fm_stations(freqs, n, fs, rng, noise=0.0):
    t = np.arange(n) / fs
    iq = noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for k, f0 in enumerate(freqs):
        msg = np.sin(2 * np.pi * (700.0 + 90.0 * k) * t)
        iq = iq + 0.5 * np.exp(1j * (2 * np.pi * f0 * t
                                     + 2 * np.pi * 75e3 * np.cumsum(msg)
                                     / fs))
    return iq.astype(np.complex64)


def test_block_len_is_the_plan_multiple():
    """No padding to kernel tiles: the default block is the smallest
    multiple of the plan's block multiple at ~60 blocks per second."""
    rx = ReceiverPipeline(8_000_000, [DemodGroupSpec("FM", 200000, 4)],
                          dtype=PLANAR)
    m = rx.group_block_multiple(0)
    assert rx.block_len % m == 0
    assert rx.block_len - m < 8_000_000 / 60 <= rx.block_len


def test_retune_mid_stream_crosses_a_channel(rng):
    """Retunes are traced inputs: moving a demod across a channel boundary
    between blocks keeps the compiled step, and from the retune on the
    moved row equals a fresh pipeline listening there from the start
    (after its filter history has flushed)."""
    fs = 8_000_000
    specs = [DemodGroupSpec("FM", 200000, 4)]
    rx = ReceiverPipeline(fs, specs, dtype=PLANAR)
    L = rx.block_len
    before = np.asarray([-1480e3, -480e3, 20e3, 1520e3], np.float32)
    after = before.copy()
    after[2] = 1020e3
    iq = _fm_stations([-1480e3, -480e3, 20e3, 1020e3, 1520e3], 4 * L, fs,
                      rng, noise=0.01)
    step = jax.jit(rx.apply)
    ctl = rx.control_template()
    ctl_fresh = rx.control_template()
    ctl_fresh[0]["frequency"] = after
    st, st_fresh = rx.init_state(), rx.init_state()
    outs, fresh = [], []
    for b in range(4):
        ctl[0]["frequency"] = before if b == 0 else after
        x = from_complex(iq[b * L:(b + 1) * L])
        st, out = step(st, (x, ctl))
        st_fresh, out_f = step(st_fresh, (x, ctl_fresh))
        outs.append(np.asarray(out["groups"][0]["audio"][2, 0]))
        fresh.append(np.asarray(out_f["groups"][0]["audio"][2, 0]))
    assert step._cache_size() == 1
    assert not np.allclose(outs[0], outs[1])          # it actually moved
    np.testing.assert_allclose(outs[3], fresh[3], atol=2e-3)


def test_sharded_matches_unsharded_at_six_channels():
    """ShardedReceiver at the 2.4 MS/s, M=6 shape on a time=2 x chan=2
    mesh of virtual devices equals the one-device pipeline."""
    from cubicsdr.parallel import make_receiver_mesh
    from cubicsdr.parallel.sharded import ShardedReceiver
    fs = 2_400_000
    mesh = make_receiver_mesh(n_time=2, n_chan=2, devices=jax.devices()[:4])
    groups = [DemodGroupSpec("FM", 200000, 4),
              DemodGroupSpec("AM", 10000, 2)]
    rx = ShardedReceiver(fs, num_channels=6, groups=groups, mesh=mesh)
    pipe = ReceiverPipeline(fs, groups, num_channels=6, dtype=PLANAR,
                            block_len=rx.block_len)
    controls = rx.control_template()
    fm = np.asarray([-780e3, -380e3, 420e3, 820e3], np.float32)
    controls[0]["frequency"] = fm
    controls[1]["frequency"][:] = 20e3
    L = rx.block_len
    t = np.arange(2 * L) / fs
    iq = _fm_stations(fm, 2 * L, fs, np.random.default_rng(4)) + (
        0.4 * (1 + 0.5 * np.sin(2 * np.pi * 700.0 * t))
        * np.exp(2j * np.pi * 20e3 * t)).astype(np.complex64)
    step_s = rx.make_step()
    step_p = jax.jit(pipe.apply)
    st_s = rx.place_state(rx.init_state())
    st_p = pipe.init_state()
    for b in range(2):
        blk = iq[b * L:(b + 1) * L]
        st_s, out_s = step_s(st_s, rx.shard_iq(blk), controls)
        st_p, out_p = step_p(st_p, (from_complex(blk), controls))
        np.testing.assert_allclose(out_s["mix"], out_p["mix"],
                                   atol=3e-3, rtol=1e-3)
        for gi in range(2):
            np.testing.assert_allclose(out_s["groups"][gi]["audio"],
                                       out_p["groups"][gi]["audio"],
                                       atol=3e-3, rtol=1e-3)
            np.testing.assert_allclose(out_s["groups"][gi]["level"],
                                       out_p["groups"][gi]["level"],
                                       atol=0.05)


def _rebuild(mgr, rx_old, st_old, keyed_old, fs):
    from cubicsdr.app.webview import _carry_streaming_state
    specs, keyed_new = plan_from_manager(mgr)
    rx_new = ReceiverPipeline(fs, specs, dtype=PLANAR,
                              block_len=rx_old.block_len)
    st_new = _carry_streaming_state(rx_old, st_old, keyed_old, rx_new,
                                    keyed_new, rx_new.init_state())
    return rx_new, st_new, keyed_new


def test_plan_rebuild_carries_surviving_rows(rng):
    """Adding a demod to a group rebuilds the plan; the survivors' frontend
    phase and filter tails carry row-wise, the new row starts cold, and the
    rebuilt plan runs."""
    fs = 8_000_000
    mgr = DemodulatorMgr()
    mgr.new_demodulator(100e6 + 20e3, "FM", 200000)
    mgr.new_demodulator(100e6 + 520e3, "FM", 200000)
    specs, keyed_old = plan_from_manager(mgr)
    rx_old = ReceiverPipeline(fs, specs, dtype=PLANAR)
    L = rx_old.block_len
    blk = rng.standard_normal((2, L)).astype(np.float32)
    x = PC(jnp.asarray(blk[0]), jnp.asarray(blk[1]))
    ctl = controls_from_manager(mgr, rx_old, keyed_old, 100e6)
    st_old, _ = rx_old.apply(rx_old.init_state(), (x, ctl))

    mgr.new_demodulator(100e6 - 480e3, "FM", 200000)
    rx_new, st_new, keyed_new = _rebuild(mgr, rx_old, st_old, keyed_old, fs)
    phase_o, hist_o, _ = st_old["groups"][0][0]
    phase_n, hist_n, _ = st_new["groups"][0][0]
    np.testing.assert_array_equal(np.asarray(phase_n)[:2],
                                  np.asarray(phase_o))
    np.testing.assert_array_equal(np.asarray(hist_n.re)[:2],
                                  np.asarray(hist_o.re))
    assert float(np.asarray(phase_n)[2]) == 0.0
    assert not np.asarray(hist_n.re)[2].any()
    ctl2 = controls_from_manager(mgr, rx_new, keyed_new, 100e6)
    _, out = rx_new.apply(st_new, (x, ctl2))
    assert np.isfinite(np.asarray(out["mix"])).all()


def test_plan_rebuild_follows_rows_when_rows_equal_channels(rng):
    """A swap that shifts rows in a 16-demod group on 16 channels moves
    each survivor's state with it, leaf by leaf."""
    fs = 8_000_000
    mgr = DemodulatorMgr()
    demods = [mgr.new_demodulator(100e6 + (i - 8) * 500e3 + 20e3,
                                  "FM", 200000) for i in range(16)]
    specs, keyed_old = plan_from_manager(mgr)
    rx_old = ReceiverPipeline(fs, specs, dtype=PLANAR)
    assert rx_old.M == 16
    leaves, treedef = jax.tree.flatten(rx_old.init_state())
    st_old = jax.tree.unflatten(treedef, [
        jnp.asarray(rng.standard_normal(np.shape(x)).astype(
            np.asarray(x).dtype)) if np.asarray(x).dtype.kind == "f" else x
        for x in leaves])
    mgr.delete_demodulator(demods[0])
    mgr.new_demodulator(100e6 + 7 * 500e3 + 120e3, "FM", 200000)
    rx_new, st_new, keyed_new = _rebuild(mgr, rx_old, st_old, keyed_old, fs)
    old_rows = list(keyed_old.values())[0]
    for nr, d in enumerate(list(keyed_new.values())[0]):
        if d not in old_rows:
            continue
        orow = old_rows.index(d)
        for a, b in zip(jax.tree.leaves(st_new["groups"][0]),
                        jax.tree.leaves(st_old["groups"][0])):
            np.testing.assert_array_equal(np.asarray(a)[nr],
                                          np.asarray(b)[orow])
