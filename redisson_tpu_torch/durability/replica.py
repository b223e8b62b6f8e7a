"""Replica-side replication link (the port's copy of
``redisson_tpu/durability/replica.py``).

A :class:`ReplicaLink` is a daemon thread holding one persistent RESP
connection to its primary.  Each session runs the bootstrap handshake
(``REPLCONF IDENT`` → ``RTPU.PSYNC``) and then the pull loop:
``RTPU.REPLFETCH`` long-polls drain the primary's
:class:`~redisson_tpu_torch.durability.replication.ReplicationHub` backlog in
seq order, every record is CRC- and contiguity-verified before ANY of
its batch is applied, and ``REPLCONF ACK <applied>`` reports progress
(the primary's ``WAIT`` fence counts these acks).

Apply path mirrors crash recovery exactly — one code path for "state
from the journal" whether the journal is a local file or a wire:

- sketch ops replay through :class:`_ReplaySession` under
  ``engine._journal_replaying`` (suppresses re-journaling), then
  ``writeback()`` installs the touched mirrors;
- ``grid.state``/``grid.del`` land via
  :meth:`GridStore.apply_journal_record` (sets ``journal_suspended``);
- ``repl.mark`` records advance ``engine._last_repl_mark``.

So a replica with a locally attached journal never re-journals the
replicated stream: its local journal stays empty until promotion, when
:func:`promote` snapshots (cutting the journal at the promoted state)
and the fresh hub starts a new replication-id lineage over it.

Resync ladder (what happens when the link breaks):

- reconnect with the remembered ``(replid, applied)`` → ``CONTINUE``
  partial resync when the primary's backlog still covers the offset;
- ``-NOBACKLOG`` / replid mismatch / primary restart → the next
  ``RTPU.PSYNC`` answers ``FULLRESYNC`` with a snapshot tar: the
  replica flushes its whole keyspace, restores the tar, and resumes
  the stream from the snapshot's journal cut.

A corrupted frame (chaos point ``repl.stream`` kind ``corrupt`` on the
primary flips payload bytes) fails the CRC check BEFORE apply — the
link resets and refetches, so a faulty link delays convergence but
never poisons state: after the fault window the replica converges
bit-identically.

Boot-time bootstrap (:func:`bootstrap_full_resync`) runs BEFORE the
client exists: it wipes the local snapshot dir and journal segments,
extracts the primary's snapshot tar in their place, and lets normal
client construction restore it — ``engine._restored_journal_seq``
then IS the replica's starting offset.
"""

from __future__ import annotations

import io
import os
import socket
import tarfile
import threading
import time
import zlib
from typing import Optional

from redisson_tpu_torch.durability.journal import decode_record
from redisson_tpu_torch.serve.wireutil import ReplyError, exchange


class ReplicaStreamError(Exception):
    """The replication stream broke (CRC mismatch, seq gap, replid
    change, ``-NOBACKLOG``) — the link must reconnect and resync."""


def _safe_extract(tar_bytes: bytes, dest: str) -> None:
    """Extract a snapshot tar, refusing path traversal (absolute names
    or ``..`` components) — the tar crosses a network link, so it is
    attacker-shaped input even between cooperating nodes."""
    os.makedirs(dest, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(tar_bytes), mode="r:*") as tf:
        for m in tf.getmembers():
            name = m.name
            if name.startswith(("/", "\\")) or ".." in name.split("/"):
                raise ReplicaStreamError(
                    f"snapshot tar member escapes dest: {name!r}"
                )
            if not (m.isfile() or m.isdir()):
                raise ReplicaStreamError(
                    f"snapshot tar member not a plain file: {name!r}"
                )
        tf.extractall(dest, filter="data")


def _wipe_local_state(snapshot_dir: Optional[str],
                      journal_dir: Optional[str]) -> None:
    """Remove local snapshot files and journal segments before a full
    resync restore — stale local segments replayed over the primary's
    snapshot would resurrect dead writes."""
    for d in (snapshot_dir,):
        if d and os.path.isdir(d):
            for fn in os.listdir(d):
                p = os.path.join(d, fn)
                if os.path.isfile(p):
                    os.unlink(p)
    if journal_dir and os.path.isdir(journal_dir):
        for fn in os.listdir(journal_dir):
            if fn.startswith("seg-") and fn.endswith(".rtj"):
                os.unlink(os.path.join(journal_dir, fn))


def bootstrap_full_resync(master_host: str, master_port: int,
                          snapshot_dir: str,
                          journal_dir: Optional[str],
                          ident: str,
                          listening_port: int = 0,
                          timeout_s: float = 30.0) -> tuple[str, int]:
    """Boot-time FULLRESYNC, run BEFORE the client is constructed.

    Fetches the primary's snapshot tar, wipes local snapshot/journal
    state, extracts the tar into ``snapshot_dir``, and returns
    ``(replid, snap_seq)``.  Normal client construction then restores
    the snapshot; the :class:`ReplicaLink` starts streaming from
    ``snap_seq`` (which equals ``engine._restored_journal_seq``)."""
    sock = socket.create_connection((master_host, master_port),
                                    timeout=timeout_s)
    try:
        sock.settimeout(timeout_s)
        ok, psync = exchange(sock, [
            ("REPLCONF", "IDENT", ident, str(listening_port)),
            ("RTPU.PSYNC", "?", "0"),
        ])
        if isinstance(ok, ReplyError):
            raise ReplicaStreamError(f"REPLCONF IDENT refused: {ok}")
        if isinstance(psync, ReplyError):
            raise ReplicaStreamError(f"PSYNC refused: {psync}")
        tag = bytes(psync[0]).decode()
        if tag != "FULLRESYNC":
            raise ReplicaStreamError(
                f"boot PSYNC expected FULLRESYNC, got {tag}"
            )
        replid = bytes(psync[1]).decode()
        snap_seq = int(psync[2])
        tar_bytes = bytes(psync[3])
    finally:
        sock.close()
    _wipe_local_state(snapshot_dir, journal_dir)
    _safe_extract(tar_bytes, snapshot_dir)
    return replid, snap_seq


class ReplicaLink(threading.Thread):
    """The replica's persistent pull link to its primary.

    Public state (read by ``INFO replication``, the staleness gate, and
    the failover agent): ``replid``, ``applied`` (= replica offset),
    ``master_offset`` (primary's last seq as of the latest fetch),
    ``link_up``, ``full_resyncs``/``partial_resyncs`` counters.
    ``lag_ops()`` is the bounded-staleness number: primary seqs not yet
    applied here."""

    def __init__(self, client, master_host: str, master_port: int,
                 ident: str, listening_port: int = 0, obs=None,
                 batch: int = 512, poll_timeout_ms: int = 500,
                 reconnect_delay_s: float = 0.3,
                 replid: Optional[str] = None):
        super().__init__(name="rtpu-repl-link", daemon=True)
        self._client = client
        self._engine = client._engine
        self.master_host = master_host
        self.master_port = int(master_port)
        self.repl_ident = ident
        self.listening_port = int(listening_port)
        self.obs = obs
        self.batch = int(batch)
        self.poll_timeout_ms = int(poll_timeout_ms)
        self.reconnect_delay_s = float(reconnect_delay_s)
        # Offset state.  `applied` starts at the snapshot cut the boot
        # bootstrap restored (0 for an empty primary).  GIL-atomic int/
        # bool reads serve INFO and the staleness gate lock-free; the
        # lock orders the promote() handshake against the apply loop.
        self._lock = threading.Lock()
        # A replid from the boot bootstrap lets the first PSYNC ride a
        # CONTINUE off the just-restored snapshot cut instead of
        # re-shipping the whole snapshot it came from.
        self.replid: Optional[str] = replid
        self.applied = int(
            getattr(self._engine, "_restored_journal_seq", 0) or 0
        )
        self.master_offset = self.applied
        self.link_up = False
        self.full_resyncs = 0
        self.partial_resyncs = 0
        self.last_resync_bytes = 0  # the last FULLRESYNC's snapshot tar
        self._stop_evt = threading.Event()
        self._sock: Optional[socket.socket] = None

    # -- public surface ----------------------------------------------------

    def lag_ops(self) -> int:
        """Primary ops not yet applied here (the staleness bound's
        input).  0 while caught up; grows during a fault window."""
        return max(0, self.master_offset - self.applied)

    def stop(self, join_timeout_s: float = 5.0) -> None:
        """Stop the link (promotion path): no further records apply
        after this returns, so the promoted state is a clean prefix of
        the primary's stream."""
        self._stop_evt.set()
        s = self._sock
        if s is not None:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        if self.is_alive():
            self.join(timeout=join_timeout_s)

    # -- session loop ------------------------------------------------------

    def run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self._session()
            except (OSError, ReplyError, ReplicaStreamError, ValueError):
                pass
            finally:
                self.link_up = False
                s, self._sock = self._sock, None
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
            if not self._stop_evt.is_set():
                time.sleep(self.reconnect_delay_s)

    def _session(self) -> None:
        sock = socket.create_connection(
            (self.master_host, self.master_port), timeout=10.0
        )
        self._sock = sock
        # Long-polls park up to poll_timeout_ms on the primary; the
        # socket timeout must comfortably exceed that or every idle
        # poll looks like a dead link.
        sock.settimeout(max(10.0, self.poll_timeout_ms / 1000.0 + 10.0))
        (ok,) = exchange(sock, [
            ("REPLCONF", "IDENT", self.repl_ident, str(self.listening_port)),
        ])
        if isinstance(ok, ReplyError):
            raise ReplicaStreamError(f"REPLCONF IDENT refused: {ok}")
        (psync,) = exchange(sock, [
            ("RTPU.PSYNC", self.replid or "?", str(self.applied)),
        ])
        if isinstance(psync, ReplyError):
            raise ReplicaStreamError(f"PSYNC refused: {psync}")
        tag = bytes(psync[0]).decode()
        if tag == "CONTINUE":
            with self._lock:
                self.replid = bytes(psync[1]).decode()
                self.partial_resyncs += 1
        elif tag == "FULLRESYNC":
            self._full_resync(psync)
        else:
            raise ReplicaStreamError(f"bad PSYNC reply tag {tag!r}")
        self.link_up = True
        while not self._stop_evt.is_set():
            (reply,) = exchange(sock, [
                ("RTPU.REPLFETCH", str(self.applied),
                 str(self.batch), str(self.poll_timeout_ms)),
            ])
            if isinstance(reply, ReplyError):
                if reply.code == "NOBACKLOG":
                    # Fell off the primary's window: forget the lineage
                    # so the reconnect PSYNC asks with "?" and gets the
                    # FULLRESYNC it needs.
                    with self._lock:
                        self.replid = None
                raise ReplicaStreamError(str(reply))
            replid = bytes(reply[0]).decode()
            if self.replid is not None and replid != self.replid:
                # Primary restarted (new journal lineage) mid-link:
                # offsets are from a different history — full resync.
                with self._lock:
                    self.replid = None
                raise ReplicaStreamError("replication id changed")
            self.master_offset = max(self.master_offset, int(reply[1]))
            self._apply_batch(reply[2])
            (ack,) = exchange(sock, [
                ("REPLCONF", "ACK", str(self.applied)),
            ])
            if isinstance(ack, ReplyError):
                raise ReplicaStreamError(f"ACK refused: {ack}")

    # -- resync + apply ----------------------------------------------------

    def _full_resync(self, psync) -> None:
        """Mid-life FULLRESYNC: flush the whole local keyspace, extract
        the primary's snapshot tar, restore engine + grid from it, and
        resume from the snapshot's journal cut."""
        replid = bytes(psync[1]).decode()
        snap_seq = int(psync[2])
        tar_bytes = bytes(psync[3])
        import shutil
        import tempfile

        tmp = tempfile.mkdtemp(prefix="rtpu-fullresync-")
        try:
            _safe_extract(tar_bytes, tmp)
            with self._lock:
                eng = self._engine
                eng._journal_replaying = True
                try:
                    self._client.get_keys().flushall()
                    eng.restore_snapshot(tmp)
                    grid_path = os.path.join(tmp, "grid_store.bin")
                    if os.path.exists(grid_path):
                        grid = self._client._grid
                        grid.journal_suspended = True
                        try:
                            grid.restore_from(grid_path)
                        finally:
                            grid.journal_suspended = False
                finally:
                    eng._journal_replaying = False
                nc = getattr(eng, "nearcache", None)
                if nc is not None:
                    nc.invalidate_all()
                self.replid = replid
                # Up before the offset moves: a reader that sees the
                # restored offset must see the link up too.
                self.link_up = True
                self.applied = snap_seq
                self.master_offset = max(self.master_offset, snap_seq)
                self.full_resyncs += 1
                self.last_resync_bytes = len(tar_bytes)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _apply_batch(self, frames) -> int:
        """Verify then apply one REPLFETCH batch.  Verification is
        all-or-nothing BEFORE any apply: a CRC mismatch or seq gap
        rejects the whole batch (link resets, refetch from `applied`),
        so corruption never lands partially."""
        recs = []
        expect = self.applied + 1
        for frame in frames:
            seq, crc, payload = int(frame[0]), int(frame[1]), bytes(frame[2])
            if seq != expect:
                raise ReplicaStreamError(
                    f"seq gap: expected {expect}, got {seq}"
                )
            if zlib.crc32(payload) != (crc & 0xFFFFFFFF):
                raise ReplicaStreamError(f"crc mismatch at seq {seq}")
            recs.append((seq, decode_record(payload)))
            expect += 1
        if not recs:
            return 0
        from redisson_tpu_torch.durability.recovery import _ReplaySession

        eng = self._engine
        grid = self._client._grid
        session = None
        with self._lock:
            if self._stop_evt.is_set():
                return 0
            eng._journal_replaying = True
            try:
                for _seq, rec in recs:
                    op = rec.get("op")
                    if op in ("grid.state", "grid.del"):
                        grid.apply_journal_record(rec)
                    elif op == "repl.mark":
                        eng._last_repl_mark = max(
                            int(getattr(eng, "_last_repl_mark", 0)),
                            int(rec["offset"]),
                        )
                    else:
                        if session is None:
                            session = _ReplaySession(eng)
                        session.apply(rec)
                if session is not None:
                    session.writeback()
            finally:
                eng._journal_replaying = False
            if session is not None:
                # Replayed rows bypass the near-cache coherence hooks
                # (exactly like crash recovery) — drop the whole cache.
                eng.nearcache.invalidate_all()
            self.applied = recs[-1][0]
        if self.obs is not None:
            self.obs.repl_stream_records.inc((), len(recs))
        return len(recs)
