"""Modem base classes, factory registry, and settings introspection.

Reference parity:
  - factory registry: Modem::addModemFactory / makeModem / getAllTypes
    (ref: src/modules/modem/Modem.h:129-138, Modem.cpp:40-63)
  - settings schema: ModemArgInfo typed key/value/range/options
    (ref: src/modules/modem/Modem.h:65-111)
  - rate contract: checkSampleRate / getDefaultSampleRate
    (ref: src/modules/modem/Modem.h:148-153, Modem.cpp:71-73)

Re-design: ``buildKit`` returns a StreamOp ("kit") closed over all design
artifacts (filters, resampler banks). Swapping settings rebuilds the kit on
the host while streaming continues on the old compiled program — the async
rebuild role of DemodulatorWorkerThread (ref: src/demod/DemodulatorWorkerThread
.cpp:54-109) without a dedicated thread.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import jax.numpy as jnp

from cubicsdr.stream.op import StreamOp

MIN_BANDWIDTH = 500           # ref: src/modules/modem/Modem.h:13
DEFAULT_AUDIO_RATE = 48000


@dataclasses.dataclass
class ModemArg:
    """Typed, introspectable modem setting (ModemArgInfo analog)."""
    key: str
    name: str
    value: Any
    arg_type: str = "float"           # float | int | string
    units: str = ""
    description: str = ""
    low: Optional[float] = None
    high: Optional[float] = None
    options: Optional[list] = None


_MODEM_REGISTRY: dict[str, type] = {}


def register_modem(cls):
    """Class decorator: Modem::addModemFactory analog."""
    _MODEM_REGISTRY[cls.name] = cls
    return cls


def make_modem(name: str, **settings) -> "Modem":
    """Modem::makeModem analog."""
    cls = _MODEM_REGISTRY[name]
    m = cls()
    for k, v in settings.items():
        m.write_setting(k, v)
    return m


def modem_names(modem_type: str | None = None) -> list[str]:
    return [n for n, c in _MODEM_REGISTRY.items()
            if modem_type is None or c.modem_type == modem_type]


class Modem:
    """Host-side modem object: holds settings, builds jittable kits."""

    name: str = "?"
    modem_type: str = "analog"
    default_sample_rate: int = 200000

    def __init__(self):
        self.settings: dict[str, Any] = {
            a.key: a.value for a in self.get_settings()}

    # --- settings introspection (ModemArgInfo analog) ---
    def get_settings(self) -> list[ModemArg]:
        return []

    def read_setting(self, key: str):
        return self.settings.get(key)

    def write_setting(self, key: str, value):
        self.settings[key] = value

    # --- rate contract ---
    @classmethod
    def check_sample_rate(cls, sample_rate: int, audio_rate: int) -> int:
        return max(int(sample_rate), MIN_BANDWIDTH)

    def block_multiple(self, sample_rate: int, audio_rate: int) -> int:
        """Input block length must be a multiple of this (XLA static-shape
        version of msresamp's variable num_written)."""
        return 1

    # --- kit construction ---
    def build_kit(self, sample_rate: int, audio_rate: int = DEFAULT_AUDIO_RATE,
                  batch_shape: tuple = (), dtype=jnp.complex64,
                  time_axis: str | None = None) -> StreamOp:
        """``dtype`` selects the IQ representation the kit's carried state
        uses: jnp.complex64 (CPU tests) or ops.planar.PLANAR (the receiver's
        representation). Kits are planes-first so the math is
        identical either way. ``time_axis``: mesh axis name when the block's
        time axis is sharded (parallel/sharded.py) — block-statistic stages
        (AGC, carrier EMAs) then use collectives so their state stays
        replicated across time shards."""
        raise NotImplementedError

    def uses_signal_output(self) -> bool:
        """Whether squelch level is computed from demodulated audio instead of
        IQ magnitude (ref: Modem::useSignalOutput, DemodulatorThread.cpp:149)."""
        return False
