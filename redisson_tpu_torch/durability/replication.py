"""Replication stream: the op journal generalized
from a crash-recovery artifact into a subscribable change stream.

The port's copy of ``redisson_tpu/durability/replication.py``: the same
wire triples and resync rules, so a port replica follows a JAX primary
and the reverse.

The primary side is a :class:`ReplicationHub` wrapped around the live
:class:`~redisson_tpu_torch.durability.journal.OpJournal`: every appended
record is fed (already encoded, in seq order — the journal's producer
lock is the ordering authority) into an in-memory
:class:`ReplBacklog` ring, and replicas pull batches with
``RTPU.REPLFETCH`` long-polls.  Offsets ARE journal seqs — one number
names a position in the total mutation order on both ends, which is
what makes ``INFO replication`` offsets and the ``WAIT`` replica-ack
fence meaningful.

Resync semantics (the PSYNC analog, keyed on replication id + offset):

- A replica arrives with ``(repl_id, offset)``.  Matching id and an
  offset still covered by the ring (or by on-disk journal segments not
  yet retired by a snapshot) → ``CONTINUE``: a partial resync streams
  ``records_after(offset)``.
- Anything else — unknown id, offset fallen off both the ring and the
  retired segments, a primary restart (each journal attach mints a new
  ``repl_id`` lineage, exactly the Redis replid-on-restart behavior) —
  → ``FULLRESYNC``: the primary ships a whole-keyspace snapshot plus
  the snapshot's journal cut, and the stream resumes from the cut.

Per-replica ack state lives here too: ``REPLCONF ACK <offset>`` lands
in :meth:`ReplicationHub.ack`, and ``WAIT <numreplicas>`` blocks in
:meth:`wait_acked` until enough replicas cover the fence offset.

Lock ordering: the journal's internal lock is held while the append
tap runs, so the tap takes only the hub lock (``repl.hub``) and the
hub NEVER calls back into journal methods while holding its own lock
(the fetch path's disk fallback runs unlocked).
"""

from __future__ import annotations

import threading
import time
import uuid
import zlib
from collections import deque
from typing import Optional

from redisson_tpu_torch.durability.journal import encode_record


def frame_payload(seq: int, payload: bytes) -> tuple[int, int, bytes]:
    """(seq, crc32, payload) — the wire triple one replicated record
    travels as.  The CRC rides OUTSIDE the payload so the replica can
    reject a corrupted link frame (chaos point ``repl.stream`` kind
    ``corrupt``) and refetch, instead of applying garbage."""
    return seq, zlib.crc32(payload), payload


class ReplBacklog:
    """Bounded in-memory ring of (seq, encoded-record) pairs — the
    partial-resync window that survives snapshot-driven segment
    retirement.  Contiguous by construction: ``feed`` is called in seq
    order under the journal's producer lock."""

    def __init__(self, max_bytes: int = 4 << 20):
        self.max_bytes = int(max_bytes)
        self._ring: deque = deque()  # (seq, payload)
        self._bytes = 0
        # Seq BEFORE the first ring entry: everything <= base is gone
        # from the ring (maybe still on disk).  Starts at the journal's
        # current tail when the hub attaches.
        self.base = 0
        self.last = 0

    def reset(self, base: int) -> None:
        self._ring.clear()
        self._bytes = 0
        self.base = self.last = int(base)

    def feed(self, seq: int, payload: bytes) -> None:
        if seq != self.last + 1:
            # A gap means the journal restarted under us — restart the
            # window; earlier offsets resolve via disk or FULLRESYNC.
            self.reset(seq - 1)
        self._ring.append((seq, payload))
        self._bytes += len(payload)
        self.last = seq
        while self._bytes > self.max_bytes and len(self._ring) > 1:
            old_seq, old_payload = self._ring.popleft()
            self._bytes -= len(old_payload)
            self.base = old_seq

    def slice_after(self, after: int, max_n: int,
                    max_bytes: int) -> Optional[list]:
        """Records with seq > ``after``: a (possibly empty) list when
        the ring covers the position, None when ``after`` fell off the
        window (caller falls back to disk, then FULLRESYNC)."""
        if after >= self.last:
            return []
        if after < self.base:
            return None
        out: list = []
        size = 0
        for seq, payload in self._ring:
            if seq <= after:
                continue
            out.append((seq, payload))
            size += len(payload)
            if len(out) >= max_n or size >= max_bytes:
                break
        return out


class ReplicationHub:
    """Primary-side replication state: the backlog ring fed by the
    journal append tap, the per-replica ack table, and the fetch/ack
    surface the ``RTPU.PSYNC`` / ``RTPU.REPLFETCH`` / ``REPLCONF ACK``
    wire verbs call into."""

    def __init__(self, journal, obs=None, backlog_bytes: int = 4 << 20):
        self.journal = journal
        self.obs = obs
        # New lineage per hub (== per journal attach): a restarted
        # primary's journal lost its unfsynced tail, so offsets from
        # the previous life must not partial-resync against this one.
        self.repl_id = uuid.uuid4().hex[:40]
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.backlog = ReplBacklog(backlog_bytes)
        self.backlog.reset(journal.last_seq())
        # replica_id -> {"offset": int, "ts": monotonic, "addr": str}
        self.acks: dict = {}
        self.fullresyncs = 0
        self.partial_resyncs = 0
        journal.tap = self._on_append  # runs under the journal lock

    # -- journal tap (ordering authority: the journal's producer lock) ----

    def _on_append(self, seq: int, payload: bytes) -> None:
        with self._cv:
            self.backlog.feed(seq, payload)
            self._cv.notify_all()

    def detach(self) -> None:
        if getattr(self.journal, "tap", None) is self._on_append:
            self.journal.tap = None

    # -- resync decision ---------------------------------------------------

    def can_continue(self, repl_id: str, offset: int) -> bool:
        """True when ``offset`` can partial-resync on this lineage —
        the ring covers it, or retired-free disk segments still do."""
        if repl_id != self.repl_id:
            return False
        with self._lock:
            ring_ok = offset >= self.backlog.base
        if ring_ok:
            return True
        try:
            return offset + 1 >= self.journal.min_available_seq()
        except Exception:
            return False

    def note_full_resync(self) -> None:
        with self._lock:
            self.fullresyncs += 1
        if self.obs is not None:
            self.obs.repl_fullresyncs.inc((), 1)

    def note_partial_resync(self) -> None:
        with self._lock:
            self.partial_resyncs += 1
        if self.obs is not None:
            self.obs.repl_partial_resyncs.inc((), 1)

    # -- the stream --------------------------------------------------------

    def fetch(self, after: int, max_n: int = 512,
              max_bytes: int = 4 << 20,
              timeout_s: float = 0.0) -> tuple[str, list]:
        """Batch of records with seq > ``after``, as (seq, crc,
        payload) wire triples.  ('CONTINUE', [...]) — possibly empty
        after a long-poll timeout — or ('NOBACKLOG', []) when the
        position fell off every retention tier (replica must
        FULLRESYNC)."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while True:
            with self._cv:
                got = self.backlog.slice_after(after, max_n, max_bytes)
                if got:
                    return "CONTINUE", [
                        frame_payload(s, p) for s, p in got
                    ]
                if got is not None:
                    # Caught up: long-poll for the next append.
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return "CONTINUE", []
                    self._cv.wait(timeout=min(remaining, 0.5))
                    continue
            # Fell off the ring — disk fallback OUTSIDE the hub lock
            # (records_after scans segment files; a concurrent snapshot
            # may retire them mid-scan, surfacing OSError → NOBACKLOG).
            try:
                if after + 1 < self.journal.min_available_seq():
                    return "NOBACKLOG", []
                out = []
                for seq, rec in self.journal.records_after(after):
                    payload = encode_record(rec)
                    out.append(frame_payload(seq, payload))
                    if len(out) >= max_n:
                        break
                if out:
                    return "CONTINUE", out
            except (OSError, ValueError):
                return "NOBACKLOG", []
            # Disk is also drained: treat as caught up and re-loop.
            after = max(after, self.journal.last_seq())

    # -- replica acks (the WAIT fence's other half) ------------------------

    def ack(self, replica_id: str, offset: int,
            addr: Optional[str] = None) -> None:
        with self._cv:
            ent = self.acks.setdefault(
                replica_id, {"offset": 0, "ts": 0.0, "addr": addr}
            )
            ent["offset"] = max(ent["offset"], int(offset))
            ent["ts"] = time.monotonic()
            if addr:
                ent["addr"] = addr
            self._cv.notify_all()
        if self.obs is not None:
            self.obs.repl_acks.inc((), 1)

    def forget(self, replica_id: str) -> None:
        with self._cv:
            self.acks.pop(replica_id, None)
            self._cv.notify_all()

    def count_acked(self, offset: int) -> int:
        with self._lock:
            return sum(
                1 for ent in self.acks.values()
                if ent["offset"] >= offset
            )

    def wait_acked(self, offset: int, numreplicas: int,
                   timeout_s: float) -> int:
        """Block until ``numreplicas`` replicas acked ``offset`` or the
        timeout lapses; returns the count either way (WAIT's reply)."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cv:
            while True:
                n = sum(
                    1 for ent in self.acks.values()
                    if ent["offset"] >= offset
                )
                if n >= numreplicas:
                    return n
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return n
                self._cv.wait(timeout=min(remaining, 0.5))

    def replica_rows(self) -> list:
        """[(replica_id, addr, offset, age_s)] for INFO replication."""
        now = time.monotonic()
        with self._lock:
            return [
                (rid, ent.get("addr"), ent["offset"],
                 now - ent["ts"])
                for rid, ent in sorted(self.acks.items())
            ]

    def max_acked(self) -> int:
        with self._lock:
            return max(
                (ent["offset"] for ent in self.acks.values()), default=0
            )
