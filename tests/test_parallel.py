"""Multi-device sharding on the virtual 8-device CPU mesh: halo-exchange
correctness (sharded == single-device bit-ish), sharded mixed-modem farm ==
the unified single-chip ReceiverPipeline, graft entry points
(SURVEY.md §4 item 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cubicsdr.ops.planar import PLANAR, from_complex
from cubicsdr.parallel import make_receiver_mesh
from cubicsdr.parallel.halo import with_halo
from cubicsdr.parallel.sharded import ShardedReceiver
from cubicsdr.receiver import ReceiverPipeline, DemodGroupSpec
from jax.sharding import PartitionSpec as P


def test_devices_available():
    assert len(jax.devices()) == 8


def test_halo_exchange_cyclic():
    mesh = make_receiver_mesh(n_time=4, n_chan=1,
                              devices=jax.devices()[:4])

    def body(x):
        return with_halo(x, 3, "time")

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("time"), out_specs=P("time")))
    x = jnp.arange(32, dtype=jnp.float32)
    sh = jax.sharding.NamedSharding(mesh, P("time"))
    y = np.asarray(fn(jax.device_put(x, sh)))
    # Each 8-sample shard becomes 11: [prev shard's last 3, own 8].
    y = y.reshape(4, 11)
    np.testing.assert_array_equal(y[1], np.r_[5, 6, 7, np.arange(8, 16)])
    np.testing.assert_array_equal(y[0], np.r_[29, 30, 31, np.arange(8)])


def _mixed_capture(fs, n_samples):
    t = np.arange(n_samples) / fs
    msg = np.sin(2 * np.pi * 1000.0 * t)
    iq = (0.7 * np.exp(1j * (2 * np.pi * 150e3 * t
                             + 2 * np.pi * 75e3 * np.cumsum(msg) / fs))
          + 0.4 * (1 + 0.5 * np.sin(2 * np.pi * 700.0 * t))
          * np.exp(2j * np.pi * 120e3 * t)              # AM at +120 kHz
          + 0.5 * np.exp(2j * np.pi * -300e3 * t)       # carrier (BPSK row)
          ).astype(np.complex64)
    return iq


@pytest.mark.parametrize("nt,nc", [(4, 2), (8, 1), (2, 2)])
def test_sharded_matches_unified_pipeline(nt, nc):
    """The sharded mixed-modem farm (FM + AM + BPSK, squelch enabled) must
    equal the unsharded ReceiverPipeline(dtype=PLANAR) on the same samples:
    halos are exact for FIR stages, EMAs replicate via collectives, and the
    channel-0 DC blocker composes its recurrence exactly across shards."""
    fs = 1_000_000
    mesh = make_receiver_mesh(n_time=nt, n_chan=nc,
                              devices=jax.devices()[: nt * nc])
    groups = [DemodGroupSpec("FM", 200000, 2 * nc),
              DemodGroupSpec("AM", 6000, nc),
              DemodGroupSpec("BPSK", 20000, nc)]
    rx = ShardedReceiver(fs, num_channels=8, groups=groups, mesh=mesh)
    pipe = ReceiverPipeline(fs, groups, chan_mode="pfbch2", num_channels=8,
                            dtype=PLANAR, block_len=rx.block_len)
    assert pipe.audio_len == rx.nt * rx.local_audio_len

    controls = rx.control_template()
    controls[0]["frequency"][:] = 150e3          # all FM rows on station 1
    controls[0]["squelch_enabled"][:] = True
    controls[0]["squelch_level"][:] = -60.0
    controls[1]["frequency"][:] = 120e3
    controls[2]["frequency"][:] = -300e3

    step_s = rx.make_step()
    step_p = jax.jit(pipe.apply)
    st_s = rx.place_state(rx.init_state())
    st_p = pipe.init_state()

    n_blocks = 3
    iq = _mixed_capture(fs, n_blocks * rx.block_len)
    for b in range(n_blocks):
        blk = iq[b * rx.block_len:(b + 1) * rx.block_len]
        st_s, out_s = step_s(st_s, rx.shard_iq(blk), controls)
        st_p, out_p = step_p(st_p, (from_complex(blk), controls))
        np.testing.assert_allclose(out_s["mix"], out_p["mix"],
                                   atol=3e-3, rtol=1e-3)
        for gi in range(len(groups)):
            gs, gp = out_s["groups"][gi], out_p["groups"][gi]
            np.testing.assert_allclose(gs["level"], gp["level"], atol=0.05)
            np.testing.assert_array_equal(gs["squelched"], gp["squelched"])
            if "audio" in gp:
                np.testing.assert_allclose(gs["audio"], gp["audio"],
                                           atol=3e-3, rtol=1e-3)
            else:
                agree = np.mean(np.asarray(gs["symbols"])
                                == np.asarray(gp["symbols"]))
                assert agree > 0.999, agree


def test_sharded_spectrum_assembly():
    """Each time shard's |FFT| frame, all-gathered over the 'time' axis,
    equals the frames computed directly from the corresponding windows of
    the unsharded stream (SURVEY §2.11 all-gather spectrum assembly)."""
    nt = 4
    mesh = make_receiver_mesh(n_time=nt, n_chan=1,
                              devices=jax.devices()[:nt])
    fft = 128
    rx = ShardedReceiver(1_000_000, num_channels=8,
                         groups=[DemodGroupSpec("FM", 200000, 2)],
                         mesh=mesh, spectrum_fft=fft)
    rng = np.random.default_rng(5)
    iq = (rng.standard_normal(rx.block_len)
          + 1j * rng.standard_normal(rx.block_len)).astype(np.complex64)
    controls = rx.control_template()
    step = rx.make_step()
    st = rx.place_state(rx.init_state())
    st, out = step(st, rx.shard_iq(iq), controls)
    mags = np.asarray(out["spectrum_mags"])
    n = fft * 2
    assert mags.shape == (nt, n)
    L = rx.local_len
    for k in range(nt):
        win = iq[(k + 1) * L - n:(k + 1) * L]
        ref = np.fft.fftshift(np.abs(np.fft.fft(win)))
        np.testing.assert_allclose(mags[k], ref, rtol=2e-3, atol=2e-2)


def test_shard_iq_local_matches_shard_iq():
    """The multi-host ingest-scatter path (make_array_from_process_local_
    data) must produce the same sharded array as the single-host placement
    on a 1-process mesh — and feed the sharded step identically."""
    mesh = make_receiver_mesh(n_time=4, n_chan=1,
                              devices=jax.devices()[:4])
    rx = ShardedReceiver(1_000_000, num_channels=8,
                         groups=[DemodGroupSpec("FM", 200000, 2)],
                         mesh=mesh)
    rng = np.random.default_rng(3)
    iq = (rng.standard_normal(rx.block_len)
          + 1j * rng.standard_normal(rx.block_len)).astype(np.complex64)
    a = rx.shard_iq(iq)
    planes = np.stack([iq.real, iq.imag]).astype(np.float32)
    b = rx.shard_iq_local(planes)
    np.testing.assert_array_equal(np.asarray(a.re), np.asarray(b.re))
    np.testing.assert_array_equal(np.asarray(a.im), np.asarray(b.im))
    assert b.re.sharding.is_equivalent_to(a.re.sharding, a.re.ndim)
    controls = rx.control_template()
    controls[0]["frequency"][:] = 150e3
    step = rx.make_step()
    st = rx.place_state(rx.init_state())
    st, out = step(st, b, controls)
    assert np.isfinite(np.asarray(out["mix"])).all()


def test_graft_entry_single():
    import __graft_entry__
    fn, (state, x) = __graft_entry__.entry()
    state2, mix, level = jax.jit(fn)(state, x)
    assert mix.ndim == 2 and mix.shape[0] == 2      # stereo mixed block
    assert np.isfinite(np.asarray(mix)).all()
    assert level.shape == (16,)


def test_graft_dryrun_multichip():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)
