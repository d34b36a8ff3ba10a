"""Planar (PC) channelizer paths == complex64 paths, streaming."""

import numpy as np
import jax.numpy as jnp
import pytest

from cubicsdr.ops.planar import PC, PLANAR, from_complex, to_complex
from cubicsdr.ops.channelizer import ChannelizerPFB, ChannelizerPFB2

RNG = np.random.default_rng(7)


def _iq(n):
    return (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
            ).astype(np.complex64)


def _stream_both(op_c, op_p, x, block):
    sc, sp = op_c.init_state(), op_p.init_state()
    for b0 in range(0, x.shape[-1], block):
        blk = x[..., b0:b0 + block]
        sc, yc = op_c.apply(sc, jnp.asarray(blk))
        sp, yp = op_p.apply(sp, from_complex(blk))
        np.testing.assert_allclose(to_complex(yp), np.asarray(yc),
                                   atol=2e-4, rtol=0)


def test_pfb_planar_matches_complex():
    M = 8
    _stream_both(ChannelizerPFB(M, dtype=jnp.complex64),
                 ChannelizerPFB(M, dtype=PLANAR), _iq(6 * M * 10), 2 * M * 10)


@pytest.mark.parametrize("fast_math", [True, False])
def test_pfb2_planar_matches_complex(fast_math):
    M = 8
    op_c = ChannelizerPFB2(M, dtype=jnp.complex64)
    op_p = ChannelizerPFB2(M, dtype=PLANAR, fast_math=fast_math)
    _stream_both(op_c, op_p, _iq(6 * (M // 2) * 20), 2 * (M // 2) * 20)


def test_pfb2_planar_parity_carry_odd_steps():
    # Blocks with an ODD step count exercise the carried (-1)^{k*s} parity.
    M = 8
    D = M // 2
    op_c = ChannelizerPFB2(M, dtype=jnp.complex64)
    op_p = ChannelizerPFB2(M, dtype=PLANAR)
    _stream_both(op_c, op_p, _iq(9 * D), 3 * D)   # 3 steps per block


def test_pfb2_planar_batched():
    M = 8
    x = np.stack([_iq(4 * M * 5), _iq(4 * M * 5)])
    op_c = ChannelizerPFB2(M, batch_shape=(2,), dtype=jnp.complex64)
    op_p = ChannelizerPFB2(M, batch_shape=(2,), dtype=PLANAR)
    _stream_both(op_c, op_p, x, 2 * M * 5)


def test_pfb_tone_lands_in_channel():
    # Planar PFB: a tone at channel 3's center lands in channel 3.
    from cubicsdr.ops.channelizer import channel_centers
    M, fs = 8, 800_000.0
    centers = channel_centers(M, fs)
    n = 40 * M
    t = np.arange(n) / fs
    x = np.exp(2j * np.pi * centers[3] * t).astype(np.complex64)
    op = ChannelizerPFB(M, dtype=PLANAR)
    s = op.init_state()
    s, y = op.apply(s, from_complex(x))
    yc = to_complex(y)
    power = np.mean(np.abs(yc[..., 10:]) ** 2, axis=-1)
    assert np.argmax(power) == 3
    assert power[3] > 100 * np.sort(power)[-2]
