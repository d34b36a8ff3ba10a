"""Block-streaming substrate.

The reference (cjcliffe/CubicSDR) moves IQ between ~11 long-lived threads via
bounded blocking queues (src/IOThread.h:158-209, src/util/ThreadBlockingQueue.h).
Here the same dataflow is a *compiled block-synchronous graph*: every stage is a
pure function ``(state, block) -> (state, block)`` with static shapes, so a whole
receiver chain jits into one XLA program; "queues" become the host-side feeder
(``cubicsdr.io``) and the per-stage carried state replaces liquid-dsp's
hidden filter objects.
"""

from cubicsdr.stream.op import StreamOp, Chain, scan_blocks

__all__ = ["StreamOp", "Chain", "scan_blocks"]
