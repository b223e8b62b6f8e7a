"""Host data grid — the broader RObject catalog beside the sketch objects,
the port's copy of ``redisson_tpu/grid`` as far as the front door needs
it: the keyspace store (name -> kind, value, TTL; WRONGTYPE guards;
snapshot codec), RKeys over both backends, buckets and counters, and the
Batch facade.  Lists, maps, sets, sorted sets, streams, geo, locks,
topics and services are not ported yet.
"""

from redisson_tpu_torch.grid.store import GridStore
from redisson_tpu_torch.grid.buckets import BinaryStream, Bucket, Buckets
from redisson_tpu_torch.grid.counters import (
    AtomicDouble,
    AtomicLong,
    DoubleAdder,
    IdGenerator,
    LongAdder,
)
from redisson_tpu_torch.grid.keys import Keys
from redisson_tpu_torch.grid.batch import Batch, BatchFuture, BatchResult

__all__ = [
    "AtomicDouble",
    "AtomicLong",
    "Batch",
    "BatchFuture",
    "BatchResult",
    "BinaryStream",
    "Bucket",
    "Buckets",
    "DoubleAdder",
    "GridStore",
    "IdGenerator",
    "Keys",
    "LongAdder",
]
