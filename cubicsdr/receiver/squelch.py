"""Signal-level estimation and squelch gating, batched per demod.

Faithful to DemodulatorThread (ref: src/demod/DemodulatorThread.cpp:142-233):
  - level = 20*log10(mean(|samples|)) over audio (signal-output modems) or IQ
  - adaptive floor/ceil: ceil decays toward level+2 at 0.05/s, floor rises
    toward level-5 at 0.15/s (scaled by block duration)
  - smoothed level: attack 0.5, decay 0.05 * sampleTime * 30
  - squelched = enabled && smoothed < squelchLevel
  - audio peak = max(|audio|)
All block-granular in the reference too — no scans needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cubicsdr.ops.planar import planes_of
from cubicsdr.stream.op import StreamOp

SMALL = 1e-20


def linear_to_db(x):
    return 20.0 * jnp.log10(jnp.maximum(x, SMALL))


class SquelchGate(StreamOp):
    """apply(state, (audio[..., N, C, L], iq[..., N, L] | None,
    squelch_level[N], squelch_enabled[N])) ->
    (state, dict(audio, squelched, level, floor, ceil, peak)).

    ``use_signal_out`` (bool per batch row) selects audio-vs-IQ level source.

    Digital groups pass ``audio=None`` (symbol modems emit no audio in the
    reference either; the signal meter still runs on IQ —
    ref: DemodulatorThread.cpp:142-196): level/floor/ceil/squelched come from
    the IQ magnitude, measured at ``sample_rate`` = the IQ rate.
    """

    def __init__(self, sample_rate: float, n_demods: int,
                 use_signal_out=None, batch_shape: tuple = (),
                 time_axis: str | None = None):
        # time_axis: block time axis sharded over a mesh axis — level/peak
        # statistics become pmean/pmax collectives so the squelch EMAs stay
        # replicated-identical on every time shard (parallel/sharded.py).
        self.sample_rate = float(sample_rate)
        self.time_axis = time_axis
        bs = (*batch_shape, n_demods)
        self.bs = bs
        self.use_signal_out = (jnp.zeros(n_demods, jnp.bool_)
                               if use_signal_out is None
                               else jnp.asarray(use_signal_out, jnp.bool_))

    def init_state(self):
        # Distinct arrays per leaf (shared objects break buffer donation).
        return {
            "level": jnp.zeros(self.bs, jnp.float32),
            "floor": jnp.full(self.bs, -100.0, jnp.float32),
            "ceil": jnp.zeros(self.bs, jnp.float32),
            "squelch_break": jnp.zeros(self.bs, jnp.bool_),
        }

    def apply(self, state, inputs):
        audio, iq, squelch_level, squelch_enabled = inputs
        ta = self.time_axis
        n_t = jax.lax.psum(1, ta) if ta is not None else 1

        def gmean(v):      # block mean (global across time shards)
            return jax.lax.pmean(v, ta) if ta is not None else v

        # Reference sampleTime = len(iq)/iqRate; the audio block spans the
        # same duration, so measure it on whichever signal exists.
        ref = audio if audio is not None else iq
        sample_time = n_t * ref.shape[-1] / self.sample_rate

        if iq is not None:
            re, im = planes_of(iq)   # complex64 or planar PC
            lvl_iq = linear_to_db(gmean(
                jnp.mean(jnp.sqrt(re * re + im * im), axis=-1)))
        if audio is not None:
            lvl_audio = linear_to_db(gmean(
                jnp.mean(jnp.abs(audio), axis=(-2, -1))))
            current = (jnp.where(self.use_signal_out, lvl_audio, lvl_iq)
                       if iq is not None else lvl_audio)
        else:
            current = lvl_iq

        sf, sc = state["floor"], state["ceil"]
        sl = jnp.asarray(squelch_level, jnp.float32)
        sc = jnp.maximum(sc, current)
        sf = jnp.minimum(sf, current)
        sc = jnp.maximum(sc, sl + 1.0)
        sc = jnp.maximum(sc, sf + 2.0)
        sc = sc - (sc - (current + 2.0)) * sample_time * 0.05
        sf = sf + ((current - 5.0) - sf) * sample_time * 0.15

        lvl = state["level"]
        attack = lvl + (current - lvl) * 0.5
        decay = lvl + (current - lvl) * 0.05 * sample_time * 30.0
        lvl = jnp.where(current > lvl, attack, decay)

        squelched = jnp.asarray(squelch_enabled, jnp.bool_) & (lvl < sl)
        # Squelch break: became open this block (drives the UI flash,
        # ref: DemodulatorThread.cpp:198-220).
        sq_break = jnp.asarray(squelch_enabled, jnp.bool_) & ~squelched

        new_state = {"level": lvl, "floor": sf, "ceil": sc,
                     "squelch_break": sq_break}
        out = {"squelched": squelched, "level": lvl,
               "floor": sf, "ceil": sc}
        if audio is not None:
            peak = jnp.max(jnp.abs(audio), axis=(-2, -1))
            out["peak"] = (jax.lax.pmax(peak, ta) if ta is not None
                           else peak)
            out["audio"] = jnp.where(squelched[..., None, None],
                                     jnp.zeros_like(audio), audio)
        return new_state, out
