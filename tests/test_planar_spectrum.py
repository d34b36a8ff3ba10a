"""Planar spectrum == complex spectrum (complex-free waterfall path)."""

import numpy as np
import jax.numpy as jnp

from cubicsdr.ops import planar as pl
from cubicsdr.visual import SpectrumProcessor
from cubicsdr.visual.planar_spectrum import PlanarSpectrumProcessor
from tests.conftest import make_tone


def test_planar_matches_complex_spectrum():
    fft_size = 512
    sp = SpectrumProcessor(fft_size)
    ps = PlanarSpectrumProcessor(fft_size)
    fs, f0 = 1e6, 125e3
    x = make_tone(ps.n * 16, f0, fs).reshape(16, ps.n)

    st_c, out_c = sp.apply(sp.init_state(), jnp.asarray(x))
    st_p, out_p = ps.apply(ps.init_state(), pl.from_complex(x))

    np.testing.assert_allclose(
        np.asarray(out_p["spectrum_points"]),
        np.asarray(out_c["spectrum_points"]), atol=2e-3)
    np.testing.assert_allclose(float(out_p["fft_ceiling"]),
                               float(out_c["fft_ceiling"]), rtol=1e-3)


def test_planar_64k_fft_frame():
    """BASELINE config #3 shape: 64k-point frames as two matmuls."""
    ps = PlanarSpectrumProcessor(32768)      # internal 65536 points
    assert ps.n == 65536 and ps.n1 * ps.n2 == 65536
    x = make_tone(ps.n, 1.25e6, 10e6).reshape(1, ps.n)
    st, out = ps.apply(ps.init_state(), pl.from_complex(x))
    pts = np.asarray(out["spectrum_points"])
    expect_bin = 32768 // 2 + int(1.25e6 / 10e6 * 32768)
    assert abs(int(pts.argmax()) - expect_bin) <= 1
