"""Host-side IO: IQ sources (the device layer stand-in), WAV writing,
recording policy.

The reference's device layer is SoapySDR hardware streaming
(ref: src/sdr/SoapySDRThread.cpp); on a server the equivalents are
recorded-capture files, synthetic signal generators, and network sockets
feeding the compiled pipeline.
"""

from cubicsdr.io.wav import WavWriter, write_wav, read_wav  # noqa: F401
from cubicsdr.io.sources import (  # noqa: F401
    FileIQSource, SyntheticSource, optimal_block_len, optimal_channel_count)
from cubicsdr.io.recorder import RecordingSink, SquelchOption  # noqa: F401
