"""cubicsdr — a software-defined-radio framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of CubicSDR
(reference: cjcliffe/CubicSDR, C++/liquid-dsp/wxWidgets): wideband IQ
channelization, NCO mixing, multi-rate resampling, analog and digital
demodulation, spectrum/waterfall processing, audio mixing/recording, and
session/config persistence — expressed as pure block-streaming functions
``(state, block) -> (state, block)`` compiled under ``jax.jit`` and sharded
over device meshes with ``shard_map``.

Layer map (mirrors SURVEY.md §1, re-architected as array programs):

  - ``cubicsdr.stream``   — block-streaming substrate (ref: src/IOThread.*,
    src/util/ThreadBlockingQueue.*); replaces the 11-thread queue graph with a
    compiled block-synchronous pipeline.
  - ``cubicsdr.ops``      — the DSP kernel library (ref: liquid-dsp
    primitives used throughout src/): NCO, FIR/IIR, polyphase resamplers,
    channelizers, discriminators, FFT spectrum math.
  - ``cubicsdr.modems``   — modem library (ref: src/modules/modem/**).
  - ``cubicsdr.visual``   — spectrum/waterfall/scope processors
    (ref: src/process/**).
  - ``cubicsdr.io``       — IQ sources, WAV writing, recording policy
    (ref: src/sdr/SoapySDRThread.*, src/audio/AudioFileWAV.*).
  - ``cubicsdr.parallel`` — mesh/sharding/halo-exchange: the distributed
    backend (channels x time sharding across devices and hosts).
  - ``cubicsdr.app``      — receiver shell: demodulator manager, config,
    sessions, bookmarks (ref: src/CubicSDR.*, src/demod/DemodulatorMgr.*,
    src/AppConfig.*, src/SessionMgr.*, src/BookmarkMgr.*).
"""

__version__ = "0.1.0"

