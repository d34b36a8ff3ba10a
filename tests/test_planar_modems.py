"""Every modem kit: planar (PC) input == complex64 input, streaming.

The kits are planes-first (modems/analog.py, modems/digital.py) so the same
code path serves both representations; these tests pin that the carried
state variants (resamplers, freqdem prev) are also equivalent.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cubicsdr.modems import make_modem, modem_names
from cubicsdr.ops.planar import PC, PLANAR, from_complex, to_complex

RNG = np.random.default_rng(11)


def _bandlimited_iq(shape, rng=RNG):
    """Smooth random IQ (keeps FM discriminator in a sane regime)."""
    n = shape[-1]
    x = rng.standard_normal((*shape[:-1], n + 32)) \
        + 1j * rng.standard_normal((*shape[:-1], n + 32))
    k = np.hanning(33)
    from scipy.signal import lfilter
    y = lfilter(k, [1.0], x, axis=-1)[..., 32:]
    return (y / np.max(np.abs(y))).astype(np.complex64)


def _flatten(out):
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    return np.asarray(out)


@pytest.mark.parametrize("name", modem_names())
def test_kit_planar_matches_complex(name):
    modem_c = make_modem(name)
    modem_p = make_modem(name)
    rate = modem_c.check_sample_rate(modem_c.default_sample_rate, 48000)
    bm = modem_c.block_multiple(rate, 48000)
    kit_c = modem_c.build_kit(rate, 48000, batch_shape=(2,),
                              dtype=jnp.complex64)
    kit_p = modem_p.build_kit(rate, 48000, batch_shape=(2,), dtype=PLANAR)
    L = int(np.lcm(bm, 16)) * 4
    x = _bandlimited_iq((2, 3 * L))
    sc, sp = kit_c.init_state(), kit_p.init_state()
    for b in range(3):
        blk = x[..., b * L:(b + 1) * L]
        sc, yc = kit_c.apply(sc, jnp.asarray(blk))
        sp, yp = kit_p.apply(sp, from_complex(blk))
        yc, yp = _flatten(yc), _flatten(yp)
        if isinstance(yc, dict):
            for k in yc:
                np.testing.assert_allclose(yp[k], yc[k], atol=1e-5, rtol=0,
                                           err_msg=f"{name}:{k}")
        else:
            # atol for the near-zero floor + rtol for fast-math NCO/atan2
            # (~2e-5 relative) scaled by AGC/gain output levels.
            scale = max(float(np.max(np.abs(yc))), 1.0)
            np.testing.assert_allclose(yp, yc, atol=1e-4 * scale, rtol=0,
                                       err_msg=name)
