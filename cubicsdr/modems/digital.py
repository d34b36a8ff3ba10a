"""Digital modem bank (reference: src/modules/modem/digital/**).

The reference's digital lab slices EVERY sample against a liquid modemcf
constellation (no timing recovery; e.g. ModemBPSK.cpp:22-32), tracks an
EVM-based lock (ModemDigital.cpp:52-54, threshold 0.005), and streams
symbol text to the DigitalConsole. Re-design: hard-decision slicing is an
argmax over constellation scores — one batched broadcast against the
constellation table instead of a per-sample loop; FSK is a matched
tone-filter bank (again a matmul over symbol frames); GMSK is the FM
discriminator + integrate-and-dump.

Kits return dicts: {"symbols": int32 [..., L_sym], "evm": f32 [...],
"locked": bool [...]} — the "audio" of a digital modem is silence in the
reference too; consumers read the symbol stream (app/digital console).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.modems.base import Modem, ModemArg, register_modem
from cubicsdr.ops.planar import planes_of
from cubicsdr.stream.op import StreamOp

LOCK_EVM = 0.005      # ref: ModemDigital.cpp:52-54


# ------------------------------------------------------------ tables ----

def psk_constellation(m: int) -> np.ndarray:
    k = np.arange(m)
    return np.exp(2j * np.pi * k / m + 1j * (np.pi / 4 if m == 4 else 0))


def dpsk_constellation(m: int) -> np.ndarray:
    """Differential-phase table: increments at exactly 2*pi*k/m (no QPSK
    rotation — the data rides on the phase *difference*)."""
    return np.exp(2j * np.pi * np.arange(m) / m)


def ask_constellation(m: int) -> np.ndarray:
    lv = (2 * np.arange(m) - (m - 1)) / (m - 1 if m > 1 else 1)
    return lv.astype(np.complex128)


def qam_constellation(m: int) -> np.ndarray:
    side = int(np.sqrt(m))
    if side * side == m:
        re, im = np.meshgrid(np.arange(side), np.arange(side))
        pts = ((2 * re - (side - 1)) + 1j * (2 * im - (side - 1))).ravel()
    else:  # cross constellation (8, 32, 128...)
        side2 = int(np.sqrt(m * 2))
        re, im = np.meshgrid(np.arange(side2), np.arange(side2 // 2))
        pts = ((2 * re - (side2 - 1)) + 1j * (2 * im - (side2 // 2 - 1))
               ).ravel()
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def apsk_constellation(m: int) -> np.ndarray:
    rings = {4: [1, 3], 8: [1, 7], 16: [4, 12], 32: [4, 12, 16],
             64: [4, 14, 20, 26], 128: [8, 24, 40, 56],
             256: [6, 18, 32, 36, 46, 52, 66]}[m]
    pts = []
    for ri, cnt in enumerate(rings):
        r = ri + 1.0
        pts.extend(r * np.exp(2j * np.pi * (np.arange(cnt) + 0.5 * ri) / cnt))
    pts = np.asarray(pts)
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def ook_constellation() -> np.ndarray:
    return np.asarray([0.0 + 0j, np.sqrt(2.0)])


def star32_constellation() -> np.ndarray:
    """'ST' 32-QAM star-like arrangement (liquid LIQUID_MODEM_ARB32OPT
    stand-in): two amplitude rings of 16-PSK."""
    inner = 0.6 * np.exp(2j * np.pi * np.arange(16) / 16)
    outer = 1.2 * np.exp(2j * np.pi * (np.arange(16) + 0.5) / 16)
    pts = np.concatenate([inner, outer])
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def sqam32_constellation() -> np.ndarray:
    """'SQAM' square-ish 32 (cross) constellation."""
    return qam_constellation(32)


# ------------------------------------------------------------- kits ----

def _ones_tail(shape, dtype):
    """1+0j tail in the kit's constructed representation (PC planes for the
    planar path, complex64 for CPU-dtype plans) — differential slicers
    seed the carried previous sample with a unit phasor."""
    from cubicsdr.ops.planar import PC, PLANAR
    if dtype is None or dtype == PLANAR:
        return PC(jnp.ones(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    return jnp.ones(shape, jnp.complex64)


class ConstellationKit(StreamOp):
    """Per-sample hard-decision slicer + EVM lock, batched.

    Scores: argmax_k 2*Re{x conj(c_k)} - |c_k|^2 (equivalent to
    nearest-point argmin without computing |x|^2).
    """

    def __init__(self, points: np.ndarray, differential: bool = False,
                 batch_shape: tuple = (), dtype=None):
        pts = np.asarray(points, np.complex128)
        self.pts_re = jnp.asarray(pts.real.astype(np.float32))
        self.pts_im = jnp.asarray(pts.imag.astype(np.float32))
        self.pts2 = jnp.asarray((np.abs(pts) ** 2).astype(np.float32))
        self.differential = differential
        self.batch_shape = batch_shape
        self.dtype = dtype
        # Time-sharding: differential slicing carries the previous sample.
        self.shard_kind = "tail" if differential else "stateless"

    def shard_halo_len(self):
        return 1

    def state_from_tail(self, tail):
        re, im = planes_of(tail)
        return (re[..., 0], im[..., 0])

    def shard_carry_init(self):
        # Carry representation follows the constructed dtype: the carried
        # tail must tree-match the input representation in streaming_halo.
        return _ones_tail((*self.batch_shape, 1), self.dtype)

    def init_state(self):
        # Differential prev-sample carried as real planes: one state layout
        # for both the complex64 and planar (PC) input representations.
        if self.differential:
            return (jnp.ones(self.batch_shape, jnp.float32),
                    jnp.zeros(self.batch_shape, jnp.float32))
        return ()

    def apply(self, state, x):
        xr, xi = planes_of(x)
        if self.differential:
            pr, pi = state
            zr = jnp.concatenate([pr[..., None], xr], axis=-1)
            zi = jnp.concatenate([pi[..., None], xi], axis=-1)
            # z[1:] * conj(z[:-1]), normalized by |z[:-1]| for the
            # phase-difference slice.
            br, bi = zr[..., :-1], zi[..., :-1]
            mag = jnp.maximum(jnp.sqrt(br * br + bi * bi), 1e-9)
            sr = (zr[..., 1:] * br + zi[..., 1:] * bi) / mag
            si = (zi[..., 1:] * br - zr[..., 1:] * bi) / mag
            new_state = (xr[..., -1], xi[..., -1])
        else:
            sr, si, new_state = xr, xi, state
        scores = (2.0 * (sr[..., None] * self.pts_re
                         + si[..., None] * self.pts_im)
                  - self.pts2)
        syms = jnp.argmax(scores, axis=-1).astype(jnp.int32)
        nre = jnp.take(self.pts_re, syms)
        nim = jnp.take(self.pts_im, syms)
        evm = jnp.mean((sr - nre) ** 2 + (si - nim) ** 2, axis=-1)
        return new_state, {"symbols": syms, "evm": evm,
                           "locked": evm < LOCK_EVM}


class FSKKit(StreamOp):
    """Incoherent M-FSK: matched tone bank over symbol frames (matmul +
    argmax), fskdem semantics (m bits, k = rate/sps samples per symbol,
    normalized bandwidth bw; ref: ModemFSK.cpp:102-150)."""

    shard_kind = "stateless"

    def __init__(self, m_bits: int, k: int, bw: float,
                 batch_shape: tuple = ()):
        self.m = 1 << m_bits
        self.k = int(k)
        n = np.arange(self.k)
        # Tone frequencies span +-bw (normalized to sample rate).
        f = (np.arange(self.m) - (self.m - 1) / 2) * (2.0 * bw / self.m)
        bank = np.exp(-2j * np.pi * np.outer(f, n))          # [M, k]
        self.bank_re = jnp.asarray(bank.real.astype(np.float32))
        self.bank_im = jnp.asarray(bank.imag.astype(np.float32))
        self.batch_shape = batch_shape

    def init_state(self):
        return ()

    def apply(self, state, x):
        assert x.shape[-1] % self.k == 0
        xr, xi = planes_of(x)
        n_sym = xr.shape[-1] // self.k
        fr_r = xr.reshape(*xr.shape[:-1], n_sym, self.k)
        fr_i = xi.reshape(*xi.shape[:-1], n_sym, self.k)
        def bank(a, b):
            return jnp.einsum("...sk,mk->...sm", a, b,
                              precision=jax.lax.Precision.HIGHEST)

        cr = bank(fr_r, self.bank_re) - bank(fr_i, self.bank_im)
        ci = bank(fr_r, self.bank_im) + bank(fr_i, self.bank_re)
        energy = cr * cr + ci * ci
        syms = jnp.argmax(energy, axis=-1).astype(jnp.int32)
        best = jnp.max(energy, axis=-1)
        tot = jnp.sum(energy, axis=-1)
        quality = jnp.mean(best / jnp.maximum(tot, 1e-12), axis=-1)
        return state, {"symbols": syms, "evm": 1.0 - quality,
                       "locked": quality > 0.8}


class GMSKKit(StreamOp):
    """GMSK via discriminator + integrate-and-dump at sps samples/symbol
    (gmskdem stand-in; ref: ModemGMSK.cpp:95-134)."""

    shard_kind = "tail"

    def shard_halo_len(self):
        return 1

    def state_from_tail(self, tail):
        re, im = planes_of(tail)
        return (re[..., 0], im[..., 0])

    def shard_carry_init(self):
        return _ones_tail((*self.batch_shape, 1), self.dtype)

    def __init__(self, sps: int, batch_shape: tuple = (), dtype=None):
        self.sps = int(sps)
        self.batch_shape = batch_shape
        self.dtype = dtype

    def init_state(self):
        return (jnp.ones(self.batch_shape, jnp.float32),
                jnp.zeros(self.batch_shape, jnp.float32))

    def apply(self, prev, x):
        assert x.shape[-1] % self.sps == 0
        xr, xi = planes_of(x)
        pr, pi = prev
        zr = jnp.concatenate([pr[..., None], xr], axis=-1)
        zi = jnp.concatenate([pi[..., None], xi], axis=-1)
        dr = zr[..., 1:] * zr[..., :-1] + zi[..., 1:] * zi[..., :-1]
        di = zi[..., 1:] * zr[..., :-1] - zr[..., 1:] * zi[..., :-1]
        d = jnp.arctan2(di, dr) * np.float32(1.0 / np.pi)   # kf = 0.5
        prev = (xr[..., -1], xi[..., -1])
        fr = d.reshape(*d.shape[:-1], d.shape[-1] // self.sps, self.sps)
        soft = jnp.mean(fr, axis=-1)
        syms = (soft > 0).astype(jnp.int32)
        mag = jnp.abs(soft)
        quality = jnp.mean(jnp.minimum(mag / jnp.maximum(
            jnp.mean(mag, axis=-1, keepdims=True), 1e-9), 1.0), axis=-1)
        return prev, {"symbols": syms, "evm": 1.0 - quality,
                      "locked": quality > 0.7}


# ------------------------------------------------------ modem classes ----

class _DigitalModem(Modem):
    modem_type = "digital"
    default_sample_rate = 200000

    def bits_per_symbol(self) -> int:
        return 1


def _const_modem(name_, points_fn, default_rate=200000, orders=None,
                 default_order=None, differential=False):
    """Factory for constellation modems, with an optional constellation-order
    setting choosing among pre-built tables (ref: ModemPSK.cpp:7-14)."""

    class _M(_DigitalModem):
        name = name_
        default_sample_rate = default_rate

        def get_settings(self):
            if orders:
                return [ModemArg("cons", "Constellation", default_order,
                                 "int", options=list(orders))]
            return []

        def bits_per_symbol(self):
            m = int(self.settings.get("cons", default_order or 2))
            if not orders:
                m = len(np.atleast_1d(points_fn()))
            return max(1, int(np.log2(m)))

        def build_kit(self, sample_rate, audio_rate=48000, batch_shape=(),
                      dtype=None, time_axis=None):
            if orders:
                m = int(self.settings.get("cons", default_order))
                pts = points_fn(m)
            else:
                pts = points_fn()
            return ConstellationKit(pts, differential, batch_shape,
                                    dtype=dtype)

    _M.__name__ = f"Modem{name_}"
    return register_modem(_M)


ModemBPSK = _const_modem("BPSK", lambda: psk_constellation(2))
ModemQPSK = _const_modem("QPSK", lambda: psk_constellation(4))
ModemOOK = _const_modem("OOK", ook_constellation)
ModemST = _const_modem("ST", star32_constellation)
ModemSQAM = _const_modem("SQAM", sqam32_constellation)
ModemPSK = _const_modem("PSK", psk_constellation,
                        orders=[2, 4, 8, 16, 32, 64, 128, 256],
                        default_order=2)
ModemDPSK = _const_modem("DPSK", dpsk_constellation,
                         orders=[2, 4, 8, 16, 32, 64, 128, 256],
                         default_order=2, differential=True)
ModemASK = _const_modem("ASK", ask_constellation,
                        orders=[2, 4, 8, 16, 32, 64, 128, 256],
                        default_order=2)
ModemQAM = _const_modem("QAM", qam_constellation,
                        orders=[4, 8, 16, 32, 64, 128, 256],
                        default_order=4)
ModemAPSK = _const_modem("APSK", apsk_constellation,
                         orders=[4, 8, 16, 32, 64, 128, 256],
                         default_order=4)


@register_modem
class ModemFSK(_DigitalModem):
    name = "FSK"
    default_sample_rate = 19200     # ref: ModemFSK.cpp:29-30

    def get_settings(self):
        return [
            ModemArg("bps", "Bits per symbol", 1, "int", low=1, high=8),
            ModemArg("sps", "Symbols per second", 9600, "int",
                     low=1, high=921600),
            ModemArg("bw", "Signal bandwidth", 0.45, "float",
                     low=0.1, high=0.49),
        ]

    def bits_per_symbol(self):
        return int(self.settings["bps"])

    def block_multiple(self, sample_rate, audio_rate=48000):
        return max(int(sample_rate) // int(self.settings["sps"]), 1)

    def build_kit(self, sample_rate, audio_rate=48000, batch_shape=(),
                  dtype=None, time_axis=None):
        k = max(int(sample_rate) // int(self.settings["sps"]), 1)
        return FSKKit(int(self.settings["bps"]), k,
                      float(self.settings["bw"]), batch_shape)


@register_modem
class ModemGMSK(_DigitalModem):
    name = "GMSK"
    default_sample_rate = 19200     # ref: ModemGMSK.cpp:31-33

    def get_settings(self):
        return [ModemArg("sps", "Samples per symbol", 4, "int",
                         low=2, high=32)]

    def block_multiple(self, sample_rate, audio_rate=48000):
        return int(self.settings["sps"])

    def build_kit(self, sample_rate, audio_rate=48000, batch_shape=(),
                  dtype=None, time_axis=None):
        return GMSKKit(int(self.settings["sps"]), batch_shape, dtype=dtype)


def symbols_to_bits(symbols: np.ndarray, bits_per_symbol: int) -> str:
    """Digital-lab console text: symbol stream -> bit string
    (ref: ModemDigital::digitalOut path, DigitalConsole)."""
    out = []
    for s in np.asarray(symbols).ravel():
        out.append(format(int(s), f"0{bits_per_symbol}b"))
    return "".join(out)
