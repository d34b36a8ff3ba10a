"""Folded-NCO frontend (tap-modulated Toeplitz resampler) == classic
mix-then-resample, streaming, for both the tiled matmul path and the
small-block fallback."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cubicsdr.ops.planar import PLANAR, from_complex, to_complex
from cubicsdr.receiver.frontend import ChannelFrontend


RNG = np.random.default_rng(7)


def _run(fe, x_blocks, omega, planar):
    st = fe.init_state()
    outs = []
    ap = jax.jit(fe.apply)
    for blk in x_blocks:
        xin = from_complex(blk) if planar else jnp.asarray(blk)
        st, y = ap(st, (xin, jnp.asarray(omega, jnp.float32)))
        outs.append(to_complex(y) if planar else np.asarray(y))
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("L_mult", [128, 3])   # tiled path / fallback path
def test_folded_frontend_matches_classic(L_mult):
    chan_rate, bw, N = 1_000_000.0, 200_000.0, 4
    fe_p = ChannelFrontend(chan_rate, bw, N, dtype=PLANAR)
    fe_c = ChannelFrontend(chan_rate, bw, N, dtype=jnp.complex64)
    assert fe_p.folded
    L = fe_p.Q * L_mult
    omega = np.asarray([0.3, -0.7, 0.0, 1.9], np.float32)
    x = (RNG.standard_normal((N, 3 * L))
         + 1j * RNG.standard_normal((N, 3 * L))).astype(np.complex64)
    blocks = [x[:, b * L:(b + 1) * L] for b in range(3)]
    yp = _run(fe_p, blocks, omega, planar=True)
    yc = _run(fe_c, blocks, omega, planar=False)
    scale = np.max(np.abs(yc))
    np.testing.assert_allclose(yp, yc, atol=3e-4 * scale, rtol=0)


def test_folded_frontend_chain_stage():
    """Multi-stage frontends (narrow bandwidth -> ResamplerChain) fold the
    NCO into stage 1 only; later stages run plain."""
    chan_rate, bw, N = 250_000.0, 6_000.0, 2
    fe_p = ChannelFrontend(chan_rate, bw, N, dtype=PLANAR)
    fe_c = ChannelFrontend(chan_rate, bw, N, dtype=jnp.complex64)
    assert fe_p.folded and fe_p._rest
    L = fe_p.Q * 64
    omega = np.asarray([0.11, -1.2], np.float32)
    x = (RNG.standard_normal((N, 2 * L))
         + 1j * RNG.standard_normal((N, 2 * L))).astype(np.complex64)
    blocks = [x[:, b * L:(b + 1) * L] for b in range(2)]
    yp = _run(fe_p, blocks, omega, planar=True)
    yc = _run(fe_c, blocks, omega, planar=False)
    scale = max(float(np.max(np.abs(yc))), 1e-3)
    np.testing.assert_allclose(yp, yc, atol=5e-4 * scale, rtol=0)
