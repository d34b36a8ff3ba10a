"""Modem library — factory registry + analog and digital demodulators.

Mirrors the reference's modem module (ref: src/modules/modem/Modem.h:129-153:
``addModemFactory/makeModem`` registry and the
``checkSampleRate -> buildKit -> demodulate -> disposeKit`` contract), with a
compiled-program contract: a modem *builds* a jittable StreamOp (the "kit") that
turns IQ blocks at the modem bandwidth into audio blocks at the audio rate.
"""

from cubicsdr.modems.base import (  # noqa: F401
    Modem, ModemArg, register_modem, make_modem, modem_names,
    MIN_BANDWIDTH,
)
from cubicsdr.modems import analog  # noqa: F401
from cubicsdr.modems import digital  # noqa: F401
