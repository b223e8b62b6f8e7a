"""Crash-safe durability tier and replication stream (the port's copy of
``redisson_tpu/durability``).

``journal.py`` — the append-only op journal (the AOF analog): every
accepted mutation is a CRC32-framed record in segment files, written by
a group-commit writer thread under the ``appendfsync always|everysec|no``
policies, truncated in coordination with snapshots (the BGREWRITEAOF
analog), and replayed deterministically through the host golden mirrors
into device rows at recovery (``recovery.py``).

``replication.py`` / ``replica.py`` — the journal as a subscribable
change stream: the primary's :class:`ReplicationHub` taps every append
into a backlog ring replicas drain over the RESP door (``RTPU.PSYNC`` /
``RTPU.REPLFETCH`` / ``REPLCONF ACK``), and a :class:`ReplicaLink`
applies the stream through the SAME replay path crash recovery uses.
Segments, records and the stream's wire triples are the JAX package's,
byte for byte, so journals, snapshots and replicas cross the packages.
"""

from redisson_tpu_torch.durability.journal import (
    FSYNC_POLICIES,
    JournalError,
    OpJournal,
    decode_record,
    encode_record,
)
from redisson_tpu_torch.durability.recovery import replay_journal
from redisson_tpu_torch.durability.replica import (
    ReplicaLink,
    ReplicaStreamError,
    bootstrap_full_resync,
)
from redisson_tpu_torch.durability.replication import ReplBacklog, ReplicationHub

__all__ = [
    "FSYNC_POLICIES",
    "JournalError",
    "OpJournal",
    "ReplBacklog",
    "ReplicaLink",
    "ReplicaStreamError",
    "ReplicationHub",
    "bootstrap_full_resync",
    "decode_record",
    "encode_record",
    "replay_journal",
]
