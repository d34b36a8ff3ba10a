"""FFTDataDistributor — re-blocker / waterfall line-rate governor.

The reference accumulates IQ into a 250 ms ring and emits exactly-fftSize
chunks paced to linesPerSecond via a fractional accumulator
(ref: src/process/FFTDataDistributor.cpp:28-142; buffer constant
CubicSDRDefs.h:69). Re-design with static shapes: each input block of L
samples yields a FIXED frame capacity [max_lines, fft_size] plus a validity
mask; frame start times follow the same fractional line pacing.

Representation: complex64 (CPU tests) or planar PC planes (dtype=PLANAR,
the app path) — the gather/reblock math is identical per plane.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cubicsdr.ops.planar import PC, PLANAR, pc_concat
from cubicsdr.stream.op import StreamOp


class FFTDataDistributor(StreamOp):
    def __init__(self, fft_size: int, sample_rate: float,
                 lines_per_second: float = 30.0, block_len: int = 0,
                 dtype=jnp.complex64):
        self.fft_size = int(fft_size)
        self.sample_rate = float(sample_rate)
        self.lps = float(lines_per_second)
        self.block_len = int(block_len)
        self.dtype = dtype
        # samples between line starts (can be < fft_size at high lps —
        # overlapping windows, like the reference's compacting ring).
        self.hop = self.sample_rate / self.lps
        if block_len:
            self.max_lines = int(np.ceil(block_len / self.hop)) + 1

    def init_state(self):
        n = self.fft_size - 1
        if self.dtype == PLANAR:
            hist = PC(jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32))
        else:
            hist = jnp.zeros(n, self.dtype)
        return (hist, jnp.zeros((), jnp.float32))    # history, next line pos

    def apply(self, state, x):
        """x: [L] complex or PC -> frames [max_lines, fft_size] (same repr),
        valid [max_lines].

        Frame k starts when the fractional accumulator crosses; start
        positions are relative to the block with fft_size-1 samples of
        history so a line may straddle the boundary.
        """
        hist, next_pos = state
        planar = isinstance(x, PC)
        L = x.shape[-1]
        if not self.block_len:
            self.block_len = L
            self.max_lines = int(np.ceil(L / self.hop)) + 1
        z = pc_concat([hist, x]) if planar else \
            jnp.concatenate([hist, x], axis=-1)
        k = jnp.arange(self.max_lines, dtype=jnp.float32)
        starts = next_pos + k * self.hop          # in block-sample units
        valid = starts <= (L - 1)
        # Window ENDS at start (newest sample), so begin fft_size-1 earlier;
        # offset by history length.
        s_idx = jnp.clip(starts, 0, L - 1).astype(jnp.int32)
        idx = s_idx[:, None] + jnp.arange(self.fft_size)[None, :]
        frames = PC(z.re[idx], z.im[idx]) if planar else z[idx]
        n_emitted = jnp.sum(valid.astype(jnp.float32))
        new_next = next_pos + n_emitted * self.hop - L
        tail = slice(z.shape[-1] - (self.fft_size - 1), None)
        new_hist = z.slice_last(tail) if planar else z[tail]
        return (new_hist, new_next), (frames, valid)
