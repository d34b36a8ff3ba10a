"""Planar-complex (PC) paths of the primitive ops == complex64 paths.

Every streaming op must produce identical results whether data flows as
complex64 (CPU tests) or as two float32 planes (the app representation).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cubicsdr.ops.planar import PC, PLANAR, from_complex, to_complex
from cubicsdr.ops.fir import FirFilter, DelayLine, FirDecimator
from cubicsdr.ops.nco import NCOMixer
from cubicsdr.ops.freqdem import FreqDem
from cubicsdr.ops.iir import DCBlocker
from cubicsdr.ops.resample import RationalResampler, make_resampler

RNG = np.random.default_rng(42)


def _iq(shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)
            ).astype(np.complex64)


def _run_both(op_c, op_p, x, n_blocks=3, tol=2e-5, extra=None):
    """Stream x through complex and planar op variants; compare outputs."""
    L = x.shape[-1] // n_blocks
    sc, sp = op_c.init_state(), op_p.init_state()
    for b in range(n_blocks):
        blk = x[..., b * L:(b + 1) * L]
        inp_c = blk if extra is None else (blk, extra)
        pc = from_complex(blk)
        inp_p = pc if extra is None else (pc, extra)
        sc, yc = op_c.apply(sc, inp_c)
        sp, yp = op_p.apply(sp, inp_p)
        yp_c = to_complex(yp) if isinstance(yp, PC) else np.asarray(yp)
        np.testing.assert_allclose(yp_c, np.asarray(yc), atol=tol, rtol=0)


def test_fir_real_taps_pc():
    taps = np.hanning(31).astype(np.float32)
    _run_both(FirFilter(taps, (2,), dtype=jnp.complex64),
              FirFilter(taps, (2,), dtype=PLANAR), _iq((2, 120)))


def test_fir_complex_taps_pc():
    taps = (np.hanning(21) * np.exp(1j * np.linspace(0, 3, 21))
            ).astype(np.complex64)
    _run_both(FirFilter(taps, (2,), dtype=jnp.complex64),
              FirFilter(taps, (2,), dtype=PLANAR), _iq((2, 90)))


def test_delay_line_pc():
    _run_both(DelayLine(7, (2,), dtype=jnp.complex64),
              DelayLine(7, (2,), dtype=PLANAR), _iq((2, 60)))


def test_fir_decimator_pc():
    taps = np.hanning(17).astype(np.float32)
    _run_both(FirDecimator(taps, 4, (2,), dtype=jnp.complex64),
              FirDecimator(taps, 4, (2,), dtype=PLANAR), _iq((2, 96)))


def test_nco_pc():
    # fast-math planar phasor: differential error ~1e-6 — compare loosely.
    omega = jnp.asarray([0.3, -1.1], jnp.float32)
    _run_both(NCOMixer((2,)), NCOMixer((2,)), _iq((2, 3 * 256)),
              tol=2e-4, extra=omega)


def test_freqdem_pc():
    x = np.exp(1j * np.cumsum(0.3 * RNG.standard_normal((2, 120)), axis=-1)
               ).astype(np.complex64)
    _run_both(FreqDem(0.5, (2,), dtype=jnp.complex64),
              FreqDem(0.5, (2,), dtype=PLANAR), x, tol=2e-5)


def test_dc_blocker_pc():
    x = _iq((2, 120)) + (0.5 + 0.25j)
    _run_both(DCBlocker(0.01, (2,), dtype=jnp.complex64),
              DCBlocker(0.01, (2,), dtype=PLANAR), x)


@pytest.mark.parametrize("P,Q", [(6, 25), (1, 12), (5, 3)])
def test_rational_resampler_pc(P, Q):
    _run_both(RationalResampler(P, Q, batch_shape=(2,), dtype=jnp.complex64),
              RationalResampler(P, Q, batch_shape=(2,), dtype=PLANAR),
              _iq((2, 3 * 4 * Q)), tol=5e-5)


def test_chain_resampler_pc():
    # Extreme ratio -> multi-stage chain; planar must match complex.
    rc = make_resampler(1, 1600, batch_shape=(1,), dtype=jnp.complex64)
    rp = make_resampler(1, 1600, batch_shape=(1,), dtype=PLANAR)
    _run_both(rc, rp, _iq((1, 3 * 1600 * 2)), tol=5e-5)


def test_real_resampler_matmul_matches_scipy():
    # Real data now routes through the Toeplitz matmul; re-pin vs upfirdn.
    from scipy.signal import upfirdn
    rs = RationalResampler(6, 25, dtype=jnp.float32)
    x = RNG.standard_normal(4 * 25 * 6).astype(np.float32)
    s = rs.init_state()
    outs = []
    L = x.shape[-1] // 2
    for b in range(2):
        s, y = rs.apply(s, jnp.asarray(x[b * L:(b + 1) * L]))
        outs.append(np.asarray(y))
    y_stream = np.concatenate(outs)
    y_ref = upfirdn(np.asarray(rs.h), x, up=rs.P, down=rs.Q)[: len(y_stream)]
    np.testing.assert_allclose(y_stream, y_ref, atol=2e-5)
