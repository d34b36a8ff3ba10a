"""DSP kernel library — the array-program replacement for liquid-dsp.

Every primitive the reference leans on (SURVEY.md §2.10) has an equivalent
here, formulated for XLA: static shapes, batched leading axes, conv/matmul
inner loops, ``lax.scan``/associative-scan for the few truly sequential
recurrences.

  liquid-dsp primitive          -> module
  ----------------------------------------------------------------
  nco_crcf mix_up/mix_down      -> ops.nco        (vectorized phasor ramp)
  firfilt/firdecim              -> ops.fir        (stateful overlap-save conv)
  iirfilt (dc blocker, sos)     -> ops.iir        (associative-scan recurrences)
  msresamp_{crcf,rrrf}          -> ops.resample   (rational polyphase, conv form)
  freqdem                       -> ops.freqdem    (phase-difference discriminator)
  firpfbch / firpfbch2          -> ops.channelizer (polyphase bank + batched FFT)
  firhilbf                      -> ops.hilbert    (analytic-signal FIR)
  fft / spgram                  -> ops.fftops     (windowed batched FFT)
  agc / autoGain                -> ops.agc        (block EMA gain)
  filter design (kaiser etc.)   -> ops.design     (host-side numpy, traced consts)
"""

from cubicsdr.ops import design  # noqa: F401
from cubicsdr.ops.nco import NCOMixer  # noqa: F401
from cubicsdr.ops.fir import FirFilter, FirDecimator  # noqa: F401
from cubicsdr.ops.iir import DCBlocker, SOSFilter  # noqa: F401
from cubicsdr.ops.freqdem import FreqDem  # noqa: F401
from cubicsdr.ops.resample import RationalResampler, design_ratio  # noqa: F401
