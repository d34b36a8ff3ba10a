"""Receiver pipeline: channel frontend, squelch, audio mixing, demodulator
instances and the manager — the array-program re-architecture of the
reference's demod/ and audio/ thread pipeline (SURVEY.md §2.3, §2.5).

Where the reference runs one PreThread+DemodThread+AudioThread trio per
receiver (ref: src/demod/DemodulatorInstance.cpp:61-80), here every active
demodulator of the same modem family is a row in ONE batched compiled
program: channelize -> gather channels -> batched NCO/resample -> batched
modem kit -> squelch/level -> mix.
"""

from cubicsdr.receiver.frontend import ChannelFrontend  # noqa: F401
from cubicsdr.receiver.squelch import SquelchGate  # noqa: F401
from cubicsdr.receiver.mixer import mix_audio  # noqa: F401
from cubicsdr.receiver.instance import DemodulatorInstance  # noqa: F401
from cubicsdr.receiver.manager import DemodulatorMgr  # noqa: F401
from cubicsdr.receiver.pipeline import (  # noqa: F401
    ReceiverPipeline, DemodGroupSpec, plan_from_manager,
    controls_from_manager)
