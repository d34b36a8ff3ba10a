"""Digital modem bank: slicers recover transmitted symbols, EVM lock
behaves, FSK/GMSK symbol recovery (ref: src/modules/modem/digital/**)."""

import numpy as np
import jax.numpy as jnp
import pytest

from cubicsdr.modems import make_modem, modem_names
from cubicsdr.modems.digital import (
    psk_constellation, qam_constellation, symbols_to_bits)


def test_registry_has_all_digital_modems():
    names = set(modem_names("digital"))
    assert {"BPSK", "QPSK", "OOK", "ST", "SQAM", "PSK", "DPSK", "ASK",
            "QAM", "APSK", "FSK", "GMSK"} <= names


@pytest.mark.parametrize("name,order", [
    ("BPSK", None), ("QPSK", None), ("OOK", None), ("ST", None),
    ("SQAM", None), ("PSK", 8), ("ASK", 4), ("QAM", 16), ("APSK", 16),
])
def test_slicer_recovers_clean_symbols(name, order, rng):
    m = make_modem(name)
    if order:
        m.write_setting("cons", order)
    kit = m.build_kit(m.default_sample_rate)
    # Transmit: random symbols straight from the kit's own constellation.
    pts = (np.asarray(kit.pts_re) + 1j * np.asarray(kit.pts_im))
    tx = rng.integers(0, len(pts), 4096)
    x = pts[tx].astype(np.complex64)
    st, out = kit.apply(kit.init_state(), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(out["symbols"]), tx)
    assert float(out["evm"]) < 1e-6
    assert bool(out["locked"])


def test_slicer_unlocks_on_noise(rng):
    kit = make_modem("QPSK").build_kit(200000)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
         ).astype(np.complex64)
    _, out = kit.apply(kit.init_state(), jnp.asarray(x))
    assert not bool(out["locked"])


def test_dpsk_differential(rng):
    m = make_modem("DPSK")
    m.write_setting("cons", 4)
    kit = m.build_kit(200000)
    # Differentially-encoded QPSK: phase increments carry the data.
    tx = rng.integers(0, 4, 1024)
    phases = np.cumsum(2 * np.pi * tx / 4)
    x = np.exp(1j * phases).astype(np.complex64)
    _, out = kit.apply(kit.init_state(), jnp.asarray(x))
    got = np.asarray(out["symbols"])
    np.testing.assert_array_equal(got, tx)


def test_fsk_roundtrip(rng):
    m = make_modem("FSK")
    m.write_setting("bps", 2)
    m.write_setting("sps", 1200)
    fs = 19200
    kit = m.build_kit(fs)
    k = fs // 1200
    M = 4
    tx = rng.integers(0, M, 256)
    bw = 0.45
    f = (tx - (M - 1) / 2) * (2 * bw / M)          # normalized tone per sym
    phase_inc = np.repeat(f, k) * 2 * np.pi
    x = np.exp(1j * np.cumsum(phase_inc)).astype(np.complex64)
    _, out = kit.apply(kit.init_state(), jnp.asarray(x))
    got = np.asarray(out["symbols"])
    assert (got == tx).mean() > 0.98
    assert bool(out["locked"])


def test_gmsk_roundtrip(rng):
    m = make_modem("GMSK")
    m.write_setting("sps", 4)
    kit = m.build_kit(19200)
    bits = rng.integers(0, 2, 512)
    # MSK-style modulation: freq +-h/(2*sps) per bit over sps samples.
    f = (bits * 2 - 1) * 0.25 / 4
    phase_inc = np.repeat(f, 4) * 2 * np.pi
    x = np.exp(1j * np.cumsum(phase_inc)).astype(np.complex64)
    _, out = kit.apply(kit.init_state(), jnp.asarray(x))
    got = np.asarray(out["symbols"])
    assert (got == bits).mean() > 0.98


def test_symbols_to_bits():
    assert symbols_to_bits(np.asarray([1, 0, 3]), 2) == "010011"


def test_modem_settings_introspection():
    m = make_modem("FSK")
    keys = {a.key for a in m.get_settings()}
    assert keys == {"bps", "sps", "bw"}
    m.write_setting("sps", 2400)
    assert m.read_setting("sps") == 2400
