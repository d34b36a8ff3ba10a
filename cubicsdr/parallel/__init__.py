"""Distributed backend: mesh construction, halo exchange, sharded receiver.

The reference has no collective backend (single desktop process,
SURVEY.md §2.11); its concurrency axes map to device mesh axes:

  reference axis                      ->  mesh axis
  ------------------------------------------------------------------
  thread pipeline over time (queues)  ->  'time'  (blocks sharded over
                                          devices, FIR history exchanged
                                          via cyclic ppermute halos — the
                                          streaming analog of context/
                                          sequence parallelism)
  independent demod chains            ->  'chan'  (demodulator rows
                                          sharded, embarrassingly parallel)

The halo trick: every stateful FIR-like stage is re-expressed as a
*stateless function of (history, samples)*; under time sharding the history
is the previous shard's tail, fetched with one cyclic ``ppermute`` per block.
Because the permute is cyclic, shard 0 receives the LAST shard's tail — which
is exactly the end of the previous block — so streaming across blocks stays
bit-continuous with zero extra bookkeeping.
"""

from cubicsdr.parallel.mesh import make_receiver_mesh  # noqa: F401
from cubicsdr.parallel.halo import halo_exchange  # noqa: F401
from cubicsdr.parallel.sharded import ShardedReceiver  # noqa: F401
