"""design_ratio degeneracy fix + multi-stage resampler chain.

Regression: design_ratio(500/800000, 500) once returned (0, 1)
— a CW demod (default 500 Hz bandwidth, ref: src/modules/modem/Modem.h:13)
on an 800 kHz channel got a P=0 resampler (silence). The reference's
msresamp handles arbitrary ratios (ref: src/demod/DemodulatorWorkerThread
.cpp:95-100); ours must snap within 0.1% or fail loudly, and extreme ratios
must cascade into multi-stage decimators with sane filter lengths.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cubicsdr.ops.planar import PC, to_complex, from_complex
from cubicsdr.ops.resample import (
    PlanarResampler, RationalResampler, ResamplerChain, design_ratio,
    make_resampler, stage_plan)


def test_design_ratio_cw_on_wide_channel():
    # The round-1 degenerate cases.
    assert design_ratio(500 / 800000, 500) == (1, 1600)
    assert design_ratio(500 / 300000, 500) == (1, 600)
    # Mild ratios unchanged.
    assert design_ratio(48000 / 200000, 500) == (6, 25)
    assert design_ratio(200000 / 800000, 500) == (1, 4)


def test_design_ratio_error_bound():
    # Every (channel_rate, bandwidth) pair from the reference's modem
    # defaults must land within 0.1% of the requested ratio.
    from cubicsdr.modems.base import _MODEM_REGISTRY
    chan_rates = [250_000, 300_000, 400_000, 500_000, 800_000, 1_000_000]
    for name, cls in _MODEM_REGISTRY.items():
        bw = cls.default_sample_rate
        for cr in chan_rates:
            P, Q = design_ratio(bw / cr, 500)
            assert P >= 1, (name, bw, cr)
            assert abs((P / Q) / (bw / cr) - 1) <= 1e-3, (name, bw, cr, P, Q)


def test_design_ratio_raises_on_degenerate():
    with pytest.raises(ValueError):
        design_ratio(0.0)
    with pytest.raises(ValueError):
        design_ratio(-1.5)


def test_stage_plan_shapes():
    assert stage_plan(6, 25) == [(6, 25)]          # mild: single stage
    assert stage_plan(96, 1) == [(96, 1)]          # pure upsample
    plan = stage_plan(1, 1600)
    assert np.prod([q for _, q in plan]) == 1600
    assert plan[0][0] == 1
    assert all(q <= 64 for _, q in plan)
    # P rides the first stage so intermediate rates stay >= final rate.
    plan = stage_plan(5, 128)
    assert plan[0] == (5, plan[0][1])
    rate = 1.0
    final = 5 / 128
    for p, q in plan:
        rate *= p / q
        assert rate >= final - 1e-12


def _tone(n, f, fs):
    t = np.arange(n) / fs
    return np.exp(2j * np.pi * f * t).astype(np.complex64)


def _tone_snr(y, f, fs_out):
    """SNR of a complex tone at f in y (projection against ideal phasor)."""
    n = len(y)
    t = np.arange(n) / fs_out
    ref = np.exp(2j * np.pi * f * t)
    c = np.vdot(ref, y) / n
    err = y - c * ref
    return 10 * np.log10(np.abs(c) ** 2 / max(np.mean(np.abs(err) ** 2),
                                              1e-30))


def test_chain_decimates_tone_cleanly():
    fs = 800_000.0
    P, Q = design_ratio(500 / fs, 500)      # (1, 1600)
    rc = ResamplerChain(P, Q)
    assert len(rc.stages) > 1
    n = Q * 200
    x = _tone(n, 50.0, fs)                  # tone inside the 500 Hz band
    st = rc.init_state()
    st, y = rc.apply(st, jnp.asarray(x))
    y = np.asarray(y)
    assert y.shape == (n // Q * P,)
    # Skip the filter warm-up, then the tone must survive cleanly.
    snr = _tone_snr(y[len(y) // 2:], 50.0, fs * P / Q)
    assert snr > 50.0, snr


def test_chain_streaming_equals_oneshot():
    fs = 320_000.0
    rc = ResamplerChain(1, 320)
    n = 320 * 64
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    st = rc.init_state()
    _, y_once = rc.apply(st, jnp.asarray(x))
    st = rc.init_state()
    outs = []
    for blk in x.reshape(4, -1):
        st, y = rc.apply(st, jnp.asarray(blk))
        outs.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(outs), np.asarray(y_once),
                               rtol=0, atol=1e-5)


def test_planar_resampler_matches_complex_chain():
    fs = 800_000.0
    P, Q = 1, 1600
    rc = ResamplerChain(P, Q)
    pr = PlanarResampler(P, Q)
    n = Q * 96
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    _, yc = rc.apply(rc.init_state(), jnp.asarray(x))
    _, yp = pr.apply(pr.init_state(), from_complex(x))
    np.testing.assert_allclose(to_complex(yp), np.asarray(yc),
                               rtol=0, atol=2e-4)


def test_planar_resampler_batched_real():
    pr = PlanarResampler(6, 25, batch_shape=(3,), complex_data=False)
    rs = make_resampler(6, 25, batch_shape=(3,), dtype=jnp.float32)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 25 * 128)).astype(np.float32)
    _, yp = pr.apply(pr.init_state(), jnp.asarray(x))
    _, yc = rs.apply(rs.init_state(), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(yp), np.asarray(yc),
                               rtol=0, atol=2e-4)


def test_frontend_cw_on_wide_channel_regression():
    # Round-1: this construction yielded a P=0 resampler (dead CW demod).
    from cubicsdr.receiver.frontend import ChannelFrontend
    fe = ChannelFrontend(800_000.0, 500.0, 1)
    assert fe.P >= 1
    n = fe.Q * 16
    tone = _tone(4 * n, 100.0, 800_000.0)
    st = fe.init_state()
    for blk in tone.reshape(4, -1):
        x = jnp.asarray(blk)[None, :]
        st, y = fe.apply(st, (x, jnp.zeros(1, jnp.float32)))
    assert y.shape[-1] == n // fe.Q * fe.P
    assert np.isfinite(np.asarray(y)).all()
    # Output is non-degenerate (the tone survives into the 500 Hz band)
    # once the multi-stage filters are warm.
    assert np.abs(np.asarray(y)).max() > 0.5


def test_shifted_resample_conv_matches_matmul():
    """The grouped-conv route form (XLA fallback HBM diet) computes the
    SAME fused shift+resample as the Toeplitz-matmul form — the two are
    interchangeable behind CUBICSDR_XLA_ROUTE (phase bookkeeping differs
    only by f32 wrapping, ~1e-4 relative)."""
    import numpy as np
    import jax.numpy as jnp
    from cubicsdr.ops.planar import PC
    from cubicsdr.ops.resample import (
        RationalResampler, planar_shifted_resample_conv,
        planar_shifted_resample_matmul)
    rng = np.random.default_rng(7)
    for P, Q in [(1, 5), (2, 5), (5, 2), (1, 64)]:
        rs = RationalResampler(P, Q)
        N, L = 5, Q * 1280
        z = PC(jnp.asarray(rng.standard_normal(
                   (N, rs.hist_len + L)).astype(np.float32)),
               jnp.asarray(rng.standard_normal(
                   (N, rs.hist_len + L)).astype(np.float32)))
        om = rng.uniform(-0.5, 0.5, N).astype(np.float32)
        ph = rng.uniform(-3, 3, N).astype(np.float32)
        a = planar_shifted_resample_matmul(z, rs, om, ph)
        b = planar_shifted_resample_conv(z, rs, om, ph)
        assert a is not None
        sc = float(np.max(np.abs(np.asarray(a.re))))
        for pa, pb in ((a.re, b.re), (a.im, b.im)):
            np.testing.assert_allclose(np.asarray(pa), np.asarray(pb),
                                       atol=4e-4 * sc)


def test_frontend_conv_route_form(monkeypatch):
    """ChannelFrontend with CUBICSDR_XLA_ROUTE=conv produces the same
    output stream as the matmul form."""
    import numpy as np
    import jax.numpy as jnp
    import cubicsdr.receiver.frontend as fr
    from cubicsdr.ops.planar import PC, PLANAR
    rng = np.random.default_rng(8)
    N, L = 3, 640 * 16
    x = PC(jnp.asarray(rng.standard_normal((N, L)).astype(np.float32)),
           jnp.asarray(rng.standard_normal((N, L)).astype(np.float32)))
    om = np.asarray([0.1, -0.3, 0.7], np.float32)
    outs = {}
    for form in ("matmul", "conv"):
        monkeypatch.setattr(fr, "XLA_ROUTE_FORM", form)
        fe = fr.ChannelFrontend(1_000_000, 200_000, N, dtype=PLANAR)
        st = fe.init_state()
        st, y1 = fe.apply(st, (x, om))
        st, y2 = fe.apply(st, (x, om))       # streaming continuity too
        outs[form] = np.stack([np.asarray(y2.re), np.asarray(y2.im)])
    sc = np.abs(outs["matmul"]).max()
    np.testing.assert_allclose(outs["conv"], outs["matmul"],
                               atol=4e-4 * sc)
