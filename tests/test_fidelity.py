"""The fidelity check itself: the mixed 2.4 MS/s plan meets its bars
between two CPU devices at full size, and ``evaluate`` catches a device
that drifts. chip_smoke.py and tests/test_gpu.py run the same functions
with a GPU as the device under test."""

import numpy as np
import jax
import pytest

from cubicsdr.receiver import fidelity as fid


@pytest.fixture(scope="module")
def small_run():
    """The plan at a small size: reference and device outputs, tx truth."""
    cpus = jax.devices("cpu")
    L = 2 * fid.block_multiple()
    iq, tx = fid.synth_capture(3 * L, seed=5)
    ref = fid.run_receiver(cpus[0], L, iq)
    dev = fid.run_receiver(cpus[1], L, iq)
    return ref, dev, tx


def test_bars_met_between_two_cpu_devices():
    cpus = jax.devices("cpu")
    res = fid.fidelity_check(cpus[1], cpus[0],
                             27 * fid.block_multiple(), 6, seed=0)
    assert res["ok"], res
    assert res["wbfm_snr_db"]["dev"] >= 80.0
    assert res["mix_max_abs_diff"] == 0.0
    for name, d in res["digital"].items():
        assert d["tx_accuracy"] == 1.0, name


def test_identical_devices_agree_exactly(small_run):
    ref, dev, tx = small_run
    assert set(ref["symbols"]) == set(fid.DIGITAL)
    assert ref["mix"].shape == dev["mix"].shape and ref["mix"].shape[0] == 2
    for name in fid.DIGITAL:
        np.testing.assert_array_equal(ref["symbols"][name],
                                      dev["symbols"][name])


def test_evaluate_catches_symbol_disagreement(small_run):
    ref, dev, tx = small_run
    bad = dict(dev, symbols=dict(dev["symbols"]))
    s = bad["symbols"]["QAM256"].copy()
    s[::50] = (s[::50] + 1) % 256
    bad["symbols"]["QAM256"] = s
    res = fid.evaluate(ref, bad, tx)
    assert not res["ok"]
    assert res["digital"]["QAM256"]["agreement"] < 0.999
    assert res["digital"]["QPSK"]["agreement"] == 1.0


def test_evaluate_catches_mix_drift(small_run):
    ref, dev, tx = small_run
    res = fid.evaluate(ref, dict(dev, mix=dev["mix"] + 2 * fid.MIX_TOL), tx)
    assert not res["ok"]
    assert res["mix_max_abs_diff"] > fid.MIX_TOL


def test_tone_snr_db_reads_a_known_snr():
    rng = np.random.default_rng(1)
    t = np.arange(48000) / 48000.0
    a = np.sin(2 * np.pi * 1000.0 * t) + 1e-3 * rng.standard_normal(t.size)
    # Tone power 0.5; white noise 1e-6 of which the 50 Hz..15 kHz share.
    expect = 10 * np.log10(0.5 / (1e-6 * (15000 - 110) / 24000))
    assert abs(fid.tone_snr_db(a, 1000.0) - expect) < 1.0


def test_stereo_separation_db_reads_a_known_ratio():
    t = np.arange(48000) / 48000.0
    left = np.sin(2 * np.pi * 1000.0 * t)
    assert abs(fid.stereo_separation_db(left, 0.01 * left) - 40.0) < 1e-6


def test_stable_mask_drops_decision_transitions():
    r = np.array([1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2])
    m = fid.stable_mask(r, k=2)
    np.testing.assert_array_equal(
        m, [1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1])


def test_tx_accuracy_finds_the_chain_delay():
    tx = np.random.default_rng(2).integers(0, 4, 200)
    dec = np.concatenate([np.zeros(7, int), np.repeat(tx, 8)])
    assert fid.tx_accuracy(dec, tx, 8) == 1.0
    assert fid.tx_accuracy((dec + 1) % 4, tx, 8) < 0.5
