"""Signal-path fidelity: one seeded mixed capture, two devices, one verdict.

The receiver's acceptance bar is the CPU-exact chain: the same plan, run on
the CPU backend in the same process, is the reference an accelerator run is
held to. The capture is 2.4 MS/s (six PFBCH2 channels, 400 kHz apart) and
carries eleven stations, each with a known message:

  analog   WBFM (1 kHz tone), FM-stereo (1 kHz tone on the LEFT channel
           only, 19 kHz pilot, 38 kHz DSB-SC subcarrier), AM (600 Hz),
           NBFM (1.5 kHz)
  digital  BPSK, QPSK, QAM-16, QAM-256, APSK-16 (held symbols, pre-rotated
           by the chain's measured complex gain so the slicer sees the true
           constellation), GMSK and binary FSK (frequency keyed)

Bars (``evaluate``):
  * WBFM recovered-tone SNR >= 80 dB, and within 1 dB of the reference;
  * FM-stereo separation within 1 dB of the reference;
  * symbol agreement >= 99.9% for every digital modem, on the samples
    whose reference decision is locally constant (a sample straddling a
    symbol transition sits arbitrarily close to a decision boundary, where
    a last-bit difference legitimately flips either backend);
  * the stereo mix within ``MIX_TOL`` of the reference, sample by sample.

``fidelity_check`` runs all of it. ``chip_smoke.py`` calls it on the GPU,
and so do the GPU-marked tests; the CPU tests call it between two CPU
devices at a small size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

FS = 2_400_000.0
NUM_CHANNELS = 6
BW = 20_000                   # digital station bandwidth (FS / BW = 120)
HOLD = 32                     # slicer samples per coherent data symbol
SYM_LEN = HOLD * int(FS // BW)            # capture samples per symbol
GMSK_SPS = 4                  # slicer frames per GMSK symbol
GHOLD = 8                     # integrate-and-dump frames per GMSK bit
FSK_SPS = 1250                # FSK symbols per second
FSK_HOLD = 8                  # FSK symbol frames per data bit
TONE_HZ = 1000.0
AUDIO_RATE = 48_000
# Mix tolerance: 1e-3 of full scale is 60 dB down, the stopband every
# filter in the chain is designed to; a device difference below it is
# under the chain's own design floor.
MIX_TOL = 1e-3


@dataclass(frozen=True)
class Station:
    name: str
    modem: str
    bandwidth: int
    offset: float                 # Hz from the capture center
    settings: tuple = ()


# Placement. Channels sit 400 kHz apart at an 800 kHz channel rate, so a
# station 800 kHz (mod FS) from a channel's center folds onto that
# channel's DC, held off only by the prototype's 60 dB stopband. WBFM has
# the -800 kHz channel to itself and nothing lands within 270 kHz of its
# center after folding; everything else is >= 1 MHz away from it.
STATIONS = (
    Station("WBFM", "FM", 200_000, -800e3),
    Station("FMS", "FMS", 250_000, -400e3),
    Station("AM", "AM", 10_000, 270e3),
    Station("NBFM", "NBFM", 12_500, 302.5e3),
    Station("BPSK", "BPSK", BW, 335e3),
    Station("QPSK", "QPSK", BW, 367.5e3),
    Station("QAM16", "QAM", BW, 400e3, (("cons", 16),)),
    Station("QAM256", "QAM", BW, 432.5e3, (("cons", 256),)),
    Station("APSK16", "APSK", BW, 465e3, (("cons", 16),)),
    Station("GMSK", "GMSK", BW, 497.5e3, (("sps", GMSK_SPS),)),
    Station("FSK", "FSK", BW, 530e3, (("bps", 1), ("sps", FSK_SPS))),
)
COHERENT = ("BPSK", "QPSK", "QAM16", "QAM256", "APSK16")
DIGITAL = COHERENT + ("GMSK", "FSK")
ANALOG = ("WBFM", "FMS", "AM", "NBFM")


def plan_specs():
    from cubicsdr.receiver.pipeline import DemodGroupSpec
    return [DemodGroupSpec(s.modem, s.bandwidth, 1, s.settings)
            for s in STATIONS]


def block_multiple() -> int:
    """Smallest block length every group of the plan accepts, also a whole
    number of coherent symbols."""
    from cubicsdr.ops.planar import PLANAR
    from cubicsdr.receiver.pipeline import ReceiverPipeline
    rx = ReceiverPipeline(FS, plan_specs(), num_channels=NUM_CHANNELS,
                          dtype=PLANAR)
    m = SYM_LEN
    for gi in range(len(STATIONS)):
        m = math.lcm(m, rx.group_block_multiple(gi))
    return m


def _tables():
    from cubicsdr.modems.digital import (apsk_constellation,
                                         psk_constellation,
                                         qam_constellation)
    return {"BPSK": psk_constellation(2), "QPSK": psk_constellation(4),
            "QAM16": qam_constellation(16),
            "QAM256": qam_constellation(256),
            "APSK16": apsk_constellation(16)}


def synth_capture(n: int, seed: int, cal: dict | None = None):
    """The eleven-station capture, ``n`` samples of complex64, and the
    transmitted symbol indices per digital station. ``cal`` maps a coherent
    station to the chain's complex gain; its baseband is divided by it."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    off = {s.name: s.offset for s in STATIONS}

    def fm(offset, msg, dev):
        return np.exp(1j * (2 * np.pi * offset * t
                            + 2 * np.pi * dev * np.cumsum(msg) / FS))

    tone = np.sin(2 * np.pi * TONE_HZ * t)
    iq = fm(off["WBFM"], tone, 75e3)
    mpx = (0.45 * tone + 0.45 * tone * np.sin(2 * np.pi * 38e3 * t)
           + 0.1 * np.sin(2 * np.pi * 19e3 * t))
    iq = iq + fm(off["FMS"], mpx, 75e3)
    iq = iq + (0.5 * (1 + 0.5 * np.sin(2 * np.pi * 600.0 * t))
               * np.exp(2j * np.pi * off["AM"] * t))
    iq = iq + 0.5 * fm(off["NBFM"], np.sin(2 * np.pi * 1500.0 * t), 2.5e3)

    tx = {}
    n_sym = n // SYM_LEN + 2
    # Held symbols with a raised-cosine move to the next one over the last
    # quarter of each hold: the held interior is what the slicer is scored
    # on, and the smooth moves keep each station's spectrum out of its
    # 32.5 kHz neighbours.
    k, pos = np.divmod(np.arange(n), SYM_LEN)
    ramp_len = SYM_LEN // 4
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.clip(
        (pos - (SYM_LEN - ramp_len)) / ramp_len, 0.0, 1.0))
    for name, pts in _tables().items():
        tx[name] = rng.integers(0, len(pts), n_sym)
        p = pts[tx[name]] / (cal or {}).get(name, 1.0)
        bb = p[k] + (p[k + 1] - p[k]) * ramp
        iq = iq + 0.5 * bb * np.exp(2j * np.pi * off[name] * t)

    # GMSK: MSK-style +-h/(2*sps) frequency keying at the slicing rate.
    bit_len = GHOLD * GMSK_SPS * int(FS // BW)
    tx["GMSK"] = rng.integers(0, 2, n // bit_len + 1)
    dev = 0.25 / GMSK_SPS * BW
    f_t = off["GMSK"] + (2.0 * tx["GMSK"] - 1.0).repeat(bit_len)[:n] * dev
    iq = iq + 0.5 * np.exp(2j * np.pi * np.cumsum(f_t) / FS)

    # Binary FSK: tones at +-0.225 * BW (the modem's normalized bw 0.45).
    bit_len = FSK_HOLD * (BW // FSK_SPS) * int(FS // BW)
    tx["FSK"] = rng.integers(0, 2, n // bit_len + 1)
    f_t = off["FSK"] + (tx["FSK"] - 0.5).repeat(bit_len)[:n] * 0.45 * BW
    iq = iq + 0.5 * np.exp(2j * np.pi * np.cumsum(f_t) / FS)
    return iq.astype(np.complex64), tx


def run_receiver(device, block_len: int, iq: np.ndarray,
                 taps: tuple = ()) -> dict:
    """Stream ``iq`` through the plan on ``device`` (planar, as the
    application runs it). Returns numpy arrays concatenated over blocks:
    ``mix`` [2, T], ``audio`` per analog station [C, T], ``symbols`` and
    mean ``evm`` per digital station, and the channel IQ of ``taps``."""
    import jax
    import jax.numpy as jnp
    from cubicsdr.ops.planar import PC, PLANAR
    from cubicsdr.receiver.pipeline import ReceiverPipeline

    n_blocks = len(iq) // block_len
    names = [s.name for s in STATIONS]
    mix, audio = [], {n: [] for n in ANALOG}
    syms, evm = {n: [] for n in DIGITAL}, {n: [] for n in DIGITAL}
    tap = {n: [] for n in taps}
    with jax.default_device(device):
        rx = ReceiverPipeline(FS, plan_specs(), num_channels=NUM_CHANNELS,
                              dtype=PLANAR, block_len=block_len)
        controls = rx.control_template()
        for gi, s in enumerate(STATIONS):
            controls[gi]["frequency"] = np.asarray([s.offset], np.float32)
        step = jax.jit(rx.apply)
        state = rx.init_state()
        for b in range(n_blocks):
            blk = iq[b * block_len:(b + 1) * block_len]
            x = PC(jnp.asarray(blk.real), jnp.asarray(blk.imag))
            state, out = step(state, (x, controls))
            mix.append(np.asarray(out["mix"]))
            for gi, name in enumerate(names):
                g = out["groups"][gi]
                if name in audio:
                    audio[name].append(np.asarray(g["audio"][0]))
                else:
                    syms[name].append(np.asarray(g["symbols"][0]))
                    evm[name].append(float(np.asarray(g["evm"][0])))
                if name in tap:
                    tap[name].append(np.asarray(g["iq"].re[0])
                                     + 1j * np.asarray(g["iq"].im[0]))
    cat = lambda d: {k: np.concatenate(v, axis=-1) for k, v in d.items()}
    return {"mix": np.concatenate(mix, axis=-1), "audio": cat(audio),
            "symbols": cat(syms),
            "evm": {k: float(np.mean(v[1:] or v)) for k, v in evm.items()},
            "taps": cat(tap), "audio_per_block": mix[0].shape[-1]}


def estimate_gains(out: dict, tx: dict) -> dict:
    """Best-delay least-squares complex gain of each coherent station's
    received constellation (from ``run_receiver(..., taps=COHERENT)``)."""
    tables = _tables()
    gains = {}
    for name in COHERENT:
        y = out["taps"][name]
        ref = np.repeat(tables[name][tx[name]], HOLD)[:y.size]
        best = None
        for d in range(3 * HOLD):
            a, r = y[d:], ref[:y.size - d]
            g = np.vdot(r, a) / np.vdot(r, r)
            err = float(np.mean(np.abs(a - g * r) ** 2))
            if best is None or err < best[0]:
                best = (err, g)
        gains[name] = complex(best[1])
    return gains


def tone_snr_db(audio: np.ndarray, f0: float, fs: float = AUDIO_RATE,
                guard: float = 30.0, fmax: float = 15_000.0) -> float:
    """Recovered-tone SNR: energy within ``guard`` Hz of ``f0`` over the
    rest of 50 Hz..``fmax`` (Hann-windowed spectrum)."""
    a = audio - audio.mean()
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    f = np.fft.rfftfreq(len(a), 1.0 / fs)
    sig = np.abs(f - f0) < guard
    noise = ~sig & (f > 50.0) & (f < fmax)
    return float(10 * np.log10(spec[sig].sum()
                               / max(spec[noise].sum(), 1e-30)))


def stereo_separation_db(left: np.ndarray, right: np.ndarray,
                         f0: float = TONE_HZ,
                         fs: float = AUDIO_RATE) -> float:
    """Left-over-right power at the left-only tone."""
    w = np.hanning(len(left))
    fl = np.abs(np.fft.rfft(left * w)) ** 2
    fr = np.abs(np.fft.rfft(right * w)) ** 2
    f = np.fft.rfftfreq(len(left), 1.0 / fs)
    k = int(np.argmin(np.abs(f - f0)))
    sl = slice(k - 2, k + 3)
    return float(10 * np.log10(fl[sl].sum() / max(fr[sl].sum(), 1e-30)))


def stable_mask(ref: np.ndarray, k: int = 2) -> np.ndarray:
    """True where the reference decision is constant over +-k samples."""
    m = np.ones(ref.shape, bool)
    for d in range(1, k + 1):
        m[d:] &= ref[d:] == ref[:-d]
        m[:-d] &= ref[:-d] == ref[d:]
    return m


def tx_accuracy(dec: np.ndarray, tx: np.ndarray, hold: int) -> float:
    """Best-delay accuracy of per-sample decisions on the interior half of
    each held symbol against the transmitted indices (the chain has no
    clock recovery, like the reference's per-sample slicing)."""
    rep = np.repeat(tx, hold)
    best = 0.0
    for d in range(3 * hold):
        n = min(len(dec) - d, len(rep))
        pos = np.arange(n) % hold
        keep = (pos >= hold // 4) & (pos < 3 * hold // 4)
        best = max(best, float((dec[d:d + n][keep] == rep[:n][keep]).mean()))
    return best


def evaluate(ref: dict, dev: dict, tx: dict) -> dict:
    """Compare a device run with the reference run on the same capture;
    returns every metric, the bars, and ``ok``."""
    skip = ref["audio_per_block"]         # first block: filter start-up
    a = lambda out, name: out["audio"][name][..., skip:]
    res = {}
    snr = {k: tone_snr_db(a(o, "WBFM")[0], TONE_HZ) for k, o in
           (("ref", ref), ("dev", dev))}
    sep = {k: stereo_separation_db(*a(o, "FMS")) for k, o in
           (("ref", ref), ("dev", dev))}
    res["wbfm_snr_db"] = snr
    res["stereo_separation_db"] = sep
    res["am_snr_db"] = tone_snr_db(a(dev, "AM")[0], 600.0)
    res["nbfm_snr_db"] = tone_snr_db(a(dev, "NBFM")[0], 1500.0)
    mix_d = float(np.max(np.abs(dev["mix"] - ref["mix"])))
    res["mix_max_abs_diff"] = mix_d
    ok = (snr["dev"] >= 80.0 and abs(snr["dev"] - snr["ref"]) <= 1.0
          and abs(sep["dev"] - sep["ref"]) <= 1.0 and mix_d <= MIX_TOL)
    holds = {n: HOLD for n in COHERENT}
    holds.update(GMSK=GHOLD, FSK=FSK_HOLD)
    digital = {}
    for name in DIGITAL:
        r, d = ref["symbols"][name], dev["symbols"][name]
        n = min(r.size, d.size)
        r, d = r[:n], d[:n]
        m = stable_mask(r)
        agree = float((r[m] == d[m]).mean())
        digital[name] = {
            "agreement": agree, "agreement_raw": float((r == d).mean()),
            "stable_frac": float(m.mean()),
            "tx_accuracy": tx_accuracy(d, tx[name], holds[name]),
            "evm_delta": abs(ref["evm"][name] - dev["evm"][name])}
        ok = ok and agree >= 0.999 and m.mean() > 0.5
    res["digital"] = digital
    res["bars"] = {"wbfm_snr_db_min": 80.0, "wbfm_snr_vs_ref_db": 1.0,
                   "separation_vs_ref_db": 1.0, "agreement_min": 0.999,
                   "mix_max_abs_diff": MIX_TOL}
    res["ok"] = bool(ok)
    return res


def fidelity_check(device, ref_device, block_len: int, n_blocks: int,
                   seed: int = 0) -> dict:
    """Calibrate on the reference device, synthesize the capture, run it on
    both devices and ``evaluate``. ``block_len`` must be a multiple of
    ``block_multiple()``."""
    if block_len % block_multiple():
        raise ValueError(f"block_len {block_len} is not a multiple of "
                         f"{block_multiple()}")
    n_cal = min(n_blocks, 2)
    iq_cal, tx_cal = synth_capture(n_cal * block_len, seed)
    cal = estimate_gains(run_receiver(ref_device, block_len, iq_cal,
                                      taps=COHERENT), tx_cal)
    iq, tx = synth_capture(n_blocks * block_len, seed, cal)
    ref = run_receiver(ref_device, block_len, iq)
    dev = run_receiver(device, block_len, iq)
    res = evaluate(ref, dev, tx)
    res.update(block_len=block_len, n_blocks=n_blocks,
               device=str(device), ref_device=str(ref_device))
    return res
