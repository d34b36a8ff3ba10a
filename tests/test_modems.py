"""Modem bank behavioral tests: each modem recovers its message from a
synthesized signal at its default rate (the framework's replacement for the
reference's delegate-to-liquid correctness, SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from cubicsdr.modems import make_modem, modem_names


def tone_snr(audio, f0, fs, guard=30.0, fmax=None):
    a = audio - audio.mean()
    w = np.hanning(len(a))
    spec = np.abs(np.fft.rfft(a * w)) ** 2
    freqs = np.fft.rfftfreq(len(a), 1 / fs)
    sig = (freqs > f0 - guard) & (freqs < f0 + guard)
    fmax = fmax or fs / 2 - 100
    noise = ~sig & (freqs > 50) & (freqs < fmax)
    return 10 * np.log10(spec[sig].sum() / max(spec[noise].sum(), 1e-30))


def run_kit(kit, x, n_blocks=8):
    s = kit.init_state()
    outs = []
    for blk in np.asarray(x).reshape(n_blocks, -1):
        s, y = kit.apply(s, jnp.asarray(blk))
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=-1)


def test_registry_has_all_analog_modems():
    names = set(modem_names("analog"))
    assert {"FM", "NBFM", "FMS", "AM", "DSB", "USB", "LSB", "CW",
            "I/Q"} <= names


def test_fm_tone():
    m = make_modem("FM")
    fs = m.default_sample_rate
    n = 25 * 8192
    t = np.arange(n) / fs
    msg = np.sin(2 * np.pi * 1e3 * t)
    x = np.exp(1j * 2 * np.pi * 75e3 * np.cumsum(msg) / fs)
    audio = run_kit(m.build_kit(fs), x.astype(np.complex64))[0]
    assert tone_snr(audio[4800:], 1e3, 48000) > 50


def test_nbfm_tone():
    m = make_modem("NBFM")
    fs = m.check_sample_rate(m.default_sample_rate, 48000)
    n = m.block_multiple(fs) * 4096
    t = np.arange(n) / fs
    msg = np.sin(2 * np.pi * 800.0 * t)
    x = np.exp(1j * 2 * np.pi * 2.5e3 * np.cumsum(msg) / fs)
    audio = run_kit(m.build_kit(fs), x.astype(np.complex64), 4)[0]
    assert tone_snr(audio[4800:], 800.0, 48000) > 40


def test_am_tone():
    m = make_modem("AM")
    fs = 6000
    n = m.block_multiple(fs) * 2048 * 4
    t = np.arange(n) / fs
    msg = np.sin(2 * np.pi * 600.0 * t)
    x = ((1.0 + 0.8 * msg) * np.exp(1j * 0.3)).astype(np.complex64)
    audio = run_kit(m.build_kit(fs), x, 4)[0]
    a = audio[9600:]
    assert tone_snr(a, 600.0, 48000) > 40
    # autoGain drives the ceiling toward 0.5.
    assert 0.2 < np.abs(a).max() < 0.8


@pytest.mark.parametrize("name,sign", [("USB", +1), ("LSB", -1)])
def test_ssb_rejects_opposite_sideband(name, sign):
    m = make_modem(name)
    fs = m.check_sample_rate(5400, 48000)
    n = m.block_multiple(fs) * 2048
    t = np.arange(n) / fs
    # In-band tone on the wanted side, another on the unwanted side.
    want = np.exp(sign * 2j * np.pi * 900.0 * t)
    unwanted = np.exp(-sign * 2j * np.pi * 1700.0 * t)
    audio_w = run_kit(m.build_kit(fs), want.astype(np.complex64), 4)[0]
    audio_u = run_kit(m.build_kit(fs), unwanted.astype(np.complex64), 4)[0]
    snr_w = tone_snr(audio_w[9600:], 900.0, 48000)
    assert snr_w > 30
    # Unwanted sideband content must be suppressed.
    pw_w = np.mean(audio_w[9600:] ** 2)
    pw_u = np.mean(audio_u[9600:] ** 2)
    assert 10 * np.log10(pw_u / pw_w) < -30


def test_cw_beep():
    m = make_modem("CW")
    fs = m.check_sample_rate(m.default_sample_rate, 48000)
    n = m.block_multiple(fs) * 512
    x = np.ones(n, np.complex64)           # carrier at DC
    audio = run_kit(m.build_kit(fs), x, 4)[0]
    assert tone_snr(audio[4800:], 650.0, 48000) > 30


def test_iq_passthrough():
    m = make_modem("I/Q")
    fs = m.check_sample_rate(123456, 48000)
    assert fs == 48000
    x = (np.arange(256) + 1j * np.arange(256, 512)).astype(np.complex64)
    kit = m.build_kit(fs)
    _, audio = kit.apply(kit.init_state(), jnp.asarray(x))
    audio = np.asarray(audio)
    np.testing.assert_allclose(audio[0], x.imag)   # left = imag
    np.testing.assert_allclose(audio[1], x.real)   # right = real


def test_dsb_product_detect():
    m = make_modem("DSB")
    fs = m.check_sample_rate(5400, 48000)
    n = m.block_multiple(fs) * 2048
    t = np.arange(n) / fs
    msg = np.sin(2 * np.pi * 700.0 * t)
    # Suppressed carrier with a small static phase offset.
    x = (msg * np.exp(1j * 0.4)).astype(np.complex64)
    audio = run_kit(m.build_kit(fs), x, 4)[0]
    assert tone_snr(audio[9600:], 700.0, 48000) > 30


def test_fm_stereo_separation():
    m = make_modem("FMS")
    fs = m.check_sample_rate(200000, 48000)
    n = m.block_multiple(fs) * 8192
    t = np.arange(n) / fs
    L = np.sin(2 * np.pi * 1000.0 * t)
    R = np.zeros_like(L)
    mono = 0.45 * (L + R)
    sub = 0.45 * (L - R) * np.sin(2 * np.pi * 38000.0 * t)
    pilot = 0.1 * np.sin(2 * np.pi * 19000.0 * t)
    msg = mono + pilot + sub
    x = np.exp(1j * 2 * np.pi * 75e3 * np.cumsum(msg) / fs)
    audio = run_kit(m.build_kit(fs), x.astype(np.complex64), 8)
    assert audio.shape[0] == 2
    aL, aR = audio[0, 19200:], audio[1, 19200:]
    pL, pR = np.mean(aL ** 2), np.mean(aR ** 2)
    sep = 10 * np.log10(pL / pR)
    # Tone on LEFT only: broadcast-grade separation is 30-40 dB; the
    # pilot-squaring chain with group-delay alignment measures ~90 dB at
    # 1 kHz (73+ dB across 0.4-10 kHz).
    assert sep > 40, f"stereo separation {sep:.1f} dB (L={pL:.2e} R={pR:.2e})"
    assert tone_snr(aL, 1000.0, 48000, fmax=15000) > 25


def test_fm_stereo_parity_vs_scipy_pll_chain():
    """Independent-implementation parity: decode the same stereo multiplex
    with a scipy chain built the REFERENCE'S way — cheby2 pilot bandpass +
    time-domain PLL + double mix-down (ref: ModemFMStereo.cpp:126-160 PLL
    setup, :230-243 double mix, :271-299 matrix) — and require both chains
    to agree: same tones, >=30 dB separation each, and >=0.99 waveform
    correlation after delay alignment."""
    import scipy.signal as sig
    from cubicsdr.modems import make_modem

    fs, fa = 200000, 48000
    m = make_modem("FMS")
    m.write_setting("demph", 0)          # compare the raw matrix outputs
    n = m.block_multiple(fs) * 8192
    t = np.arange(n) / fs
    L = np.sin(2 * np.pi * 1000.0 * t)
    R = 0.5 * np.sin(2 * np.pi * 2500.0 * t)
    mono = 0.45 * (L + R)
    sub = 0.45 * (L - R) * np.sin(2 * np.pi * 38000.0 * t)
    pilot = 0.1 * np.sin(2 * np.pi * 19000.0 * t)
    msg = mono + pilot + sub
    x = np.exp(1j * 2 * np.pi * 75e3 * np.cumsum(msg) / fs)

    ours = run_kit(m.build_kit(fs), x.astype(np.complex64), 8)

    # --- scipy PLL chain (independent math) ---
    dem = np.angle(np.conj(x[:-1]) * x[1:]) * fs / (2 * np.pi * 75e3)
    dem = np.concatenate([[dem[0]], dem])
    b, a = sig.cheby2(4, 60, [18500 / (fs / 2), 19500 / (fs / 2)],
                      btype="bandpass")
    p = sig.lfilter(b, a, dem)
    # Time-domain PLL locked to the pilot (the nco_crcf pll role).
    theta, w = 0.0, 2 * np.pi * 19000.0 / fs
    alpha, beta = 0.05, 0.05 * 0.05 / 4
    th = np.empty(n)
    for i in range(n):
        th[i] = theta
        err = p[i] * -np.sin(theta)      # phase detector (pilot ~ sin)
        w += beta * err
        theta = (theta + w + alpha * err) % (2 * np.pi)
    # Double mix-down: S rides at 2x the pilot phase.
    s_bb = dem * np.sin(2 * th)
    lp = sig.firwin(401, 16000 / (fs / 2))
    s_f = 2.0 * sig.lfilter(lp, 1.0, s_bb)
    m_f = sig.lfilter(lp, 1.0, dem)
    up, down = fa // np.gcd(fs, fa), fs // np.gcd(fs, fa)
    mono_a = sig.resample_poly(m_f, up, down)
    s_a = sig.resample_poly(s_f, up, down)
    k = 0.568 * 2 * np.pi * 75e3 / fs    # undo the discriminator scaling
    # PLL pilot recovery lands on the OPPOSITE S sign to pilot-squaring —
    # the reference's chain uses the mono-MINUS form for left for the same
    # reason (ref: ModemFMStereo.cpp:283-293; kit docstring).
    ref_L = k * (mono_a - s_a)
    ref_R = k * (mono_a + s_a)

    def sep_db(aL, aR, fL=1000.0, fR=2500.0):
        """Separation via tone-bin power: L-tone leakage into R."""
        w = np.hanning(len(aL))
        FL = np.abs(np.fft.rfft(aL * w)) ** 2
        FR = np.abs(np.fft.rfft(aR * w)) ** 2
        f = np.fft.rfftfreq(len(aL), 1 / fa)
        kL = np.argmin(np.abs(f - fL))
        return 10 * np.log10(FL[kL - 2: kL + 3].sum()
                             / FR[kL - 2: kL + 3].sum())

    cut = fa // 2
    oL, oR = np.asarray(ours[0][cut:]), np.asarray(ours[1][cut:])
    rL, rR = ref_L[cut: cut + len(oL)], ref_R[cut: cut + len(oR)]
    assert sep_db(oL, oR) > 30, "our chain below broadcast separation"
    assert sep_db(rL, rR) > 30, "scipy PLL chain below 30 dB (harness bug)"

    # Waveform parity after delay alignment (chains have different group
    # delays; amplitudes normalized).
    def aligned_corr(a, b, max_lag=400):
        a = a - a.mean(); b = b - b.mean()
        c = np.correlate(a, b[max_lag:-max_lag], mode="valid")
        k = np.argmax(np.abs(c))
        bb = b[max_lag:-max_lag]
        aa = a[k: k + len(bb)]
        return np.abs(np.corrcoef(aa, bb)[0, 1])

    assert aligned_corr(oL, rL) > 0.99
    assert aligned_corr(oR, rR) > 0.99
