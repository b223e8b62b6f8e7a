"""Append-only op journal with group commit.

The port's copy of ``redisson_tpu/durability/journal.py``: the same
record codec, frames and segment files, so a journal written by either
package replays into the other, byte for byte.

The snapshot tier (objects/durability.py) is periodic: a kill between
snapshots silently discards every acked mutation since the last one.
This module closes that gap the way Redis AOF does — every ACCEPTED
mutation (see the acceptance note below) is appended as a CRC32-framed
record to segment files, a single group-commit writer thread batches
records per fsync, and recovery replays the post-snapshot tail through
the host golden engine (durability/recovery.py).

Durability contract, by ``journal_fsync`` policy:

- ``always``   — an op's future resolves only after its record is
  fsynced (the engine wraps results in a durable gate); journal lag
  rides the coalescer's admission estimate so a slow disk sheds load
  instead of queueing unboundedly.  No acked write is ever lost.
- ``everysec`` — the writer fsyncs at most ~1 s apart; a crash loses at
  most the un-fsynced window (bounded, asserted by the crash harness).
- ``no``       — write() only; the OS decides.  ``WAIT`` (the journal
  fence) still forces an explicit fsync under every policy.

Acceptance semantics: a record is appended after the op passed
validation + admission and its dispatch was initiated — NOT after its
device completion.  A crash can therefore recover an accepted op whose
caller never saw the ack (allowed: un-acked state is unconstrained),
and an accepted op whose async device launch later failed replays its
golden effect (the caller saw the failure; recovery restores the
effect the journal promised at acceptance).

On-disk format (little-endian):

- segment file ``seg-<first_seq>.rtj``:
  ``RTPJ | u16 version | u64 first_seq`` then frames
- frame: ``u32 payload_len | u32 crc32(payload) | payload``
- payload: ``u32 header_len | json header | concat(raw array bytes)``
  where the header carries the record's scalar fields plus the dtype/
  shape manifest of its arrays (data-only — no pickle, same rule as
  dump blobs).

Torn tail: recovery scans segments in seq order and TRUNCATES at the
first frame whose length/CRC does not check out (a crash mid-write);
every earlier record stays intact, every later segment is discarded.
Record seqs are implicit (segment first_seq + index), which is safe
exactly because truncation only ever keeps a prefix.

Snapshot coordination: ``snapshot()`` records ``cut()`` (the last
appended seq) in its metadata while holding the engine's journal gate,
and calls ``mark_snapshot(cut)`` once the snapshot files are durable —
the journal rotates and retires every segment fully covered by the
snapshot (the BGREWRITEAOF analog).

Chaos points: ``journal.write`` before a
batch write, ``journal.fsync`` before each fsync, ``journal.torn_tail``
per frame — when it fires the writer emits exactly half the frame and
breaks the journal, simulating a crash mid-write.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Iterator, Optional

import numpy as np

from redisson_tpu_torch import chaos as _chaos

_MAGIC = b"RTPJ"
_VERSION = 1
_HDR = struct.Struct("<HQ")  # version, first_seq (after the 4-byte magic)
_FRAME = struct.Struct("<II")  # payload_len, crc32
_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".rtj"
# A frame longer than this is treated as a torn length word, not a
# record (the biggest legitimate records — RESTORE blobs, bulk key
# blocks — sit far below it).
MAX_RECORD_BYTES = 256 << 20

FSYNC_POLICIES = ("always", "everysec", "no")


class JournalError(RuntimeError):
    """The journal is broken (I/O failure or injected fault) or closed:
    appends and durability waits refuse instead of silently dropping
    records — under ``always`` the caller's write fails BEFORE it could
    be acked without durability."""


# -- record codec -------------------------------------------------------------


def encode_record(rec: dict) -> bytes:
    """Data-only record payload: JSON header for scalar fields + the
    dtype/shape manifest, raw array bytes appended in manifest order.
    ``bytes`` values ride as uint8 arrays (JSON-safe header)."""
    fields = {}
    arrays = []  # (key, ndarray) in sorted-key order
    for k in sorted(rec):
        v = rec[k]
        if isinstance(v, (bytes, bytearray, memoryview)):
            v = np.frombuffer(bytes(v), np.uint8)
        if isinstance(v, np.ndarray):
            arrays.append((k, np.ascontiguousarray(v)))
        elif isinstance(v, (np.integer,)):
            fields[k] = int(v)
        elif isinstance(v, (np.floating,)):
            fields[k] = float(v)
        elif isinstance(v, (np.bool_,)):
            fields[k] = bool(v)
        else:
            fields[k] = v
    header = {
        "f": fields,
        "a": [[k, a.dtype.str, list(a.shape)] for k, a in arrays],
    }
    hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
    parts = [struct.pack("<I", len(hj)), hj]
    parts.extend(a.tobytes() for _, a in arrays)
    return b"".join(parts)


def decode_record(payload: bytes) -> dict:
    """Inverse of :func:`encode_record`.  Validates declared sizes
    against the bytes present BEFORE allocating (same discipline as
    safe_load_npy) — the CRC already screened corruption, this screens
    a malformed-but-checksummed record."""
    if len(payload) < 4:
        raise ValueError("record too short")
    (hlen,) = struct.unpack_from("<I", payload, 0)
    if hlen > len(payload) - 4:
        raise ValueError("record header overruns payload")
    header = json.loads(payload[4 : 4 + hlen].decode("utf-8"))
    rec = dict(header.get("f", {}))
    off = 4 + hlen
    for k, dtype_str, shape in header.get("a", []):
        dt = np.dtype(dtype_str)
        if dt.hasobject:
            raise ValueError("object arrays are not allowed in records")
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = count * dt.itemsize
        if nbytes > len(payload) - off:
            raise ValueError(
                f"array {k!r} declares {nbytes} bytes, "
                f"{len(payload) - off} remain"
            )
        rec[k] = np.frombuffer(
            payload, dtype=dt, count=count, offset=off
        ).reshape(shape)
        off += nbytes
    return rec


# -- segment scan -------------------------------------------------------------


def _seg_path(directory: str, first_seq: int) -> str:
    return os.path.join(
        directory, f"{_SEG_PREFIX}{first_seq:016d}{_SEG_SUFFIX}"
    )


def _scan_segment(path: str):
    """(first_seq, payload_offsets, good_end, clean) for one segment.

    ``payload_offsets`` is a list of (offset, length) for every frame
    whose length and CRC verify; ``good_end`` is the file offset just
    past the last good frame (the truncation point when ``clean`` is
    False); ``first_seq`` is None when even the header is unreadable
    (the whole file is garbage — a crash during rotation)."""
    frames: list[tuple[int, int]] = []
    with open(path, "rb") as f:
        head = f.read(4 + _HDR.size)
        if len(head) < 4 + _HDR.size or head[:4] != _MAGIC:
            return None, frames, 0, False
        version, first_seq = _HDR.unpack_from(head, 4)
        if version != _VERSION:
            return None, frames, 0, False
        good_end = 4 + _HDR.size
        while True:
            fh = f.read(_FRAME.size)
            if len(fh) == 0:
                return first_seq, frames, good_end, True
            if len(fh) < _FRAME.size:
                return first_seq, frames, good_end, False
            plen, crc = _FRAME.unpack(fh)
            if plen == 0 or plen > MAX_RECORD_BYTES:
                return first_seq, frames, good_end, False
            payload = f.read(plen)
            if len(payload) < plen or zlib.crc32(payload) != crc:
                return first_seq, frames, good_end, False
            frames.append((good_end + _FRAME.size, plen))
            good_end += _FRAME.size + plen


def _fsync_dir(directory: str) -> None:
    """fsync the directory entry so renames/creates/unlinks inside it
    survive a host crash (a file's own fsync does not cover its name)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover — platform without dir-open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# -- the journal --------------------------------------------------------------


class _Segment:
    __slots__ = ("path", "first_seq", "count")

    def __init__(self, path: str, first_seq: int, count: int):
        self.path = path
        self.first_seq = first_seq
        self.count = count

    @property
    def last_seq(self) -> int:
        return self.first_seq + self.count - 1


class OpJournal:
    """Append-only op journal with a group-commit writer thread.

    Thread model: producers call :meth:`append` (enqueue + seq assign
    under the queue lock — no I/O on the producer path); ONE writer
    thread drains the queue, writes frames, rotates segments, and
    fsyncs per policy; :meth:`wait_durable` blocks on the durable
    condition.  ``cut``/``mark_snapshot`` coordinate truncation with
    the snapshot tier.
    """

    def __init__(self, directory: str, fsync_policy: str = "everysec",
                 max_segment_bytes: int = 64 << 20, obs=None,
                 fresh: bool = False):
        if fsync_policy not in FSYNC_POLICIES:
            raise ValueError(
                f"journal_fsync must be one of {FSYNC_POLICIES}, "
                f"got {fsync_policy!r}"
            )
        self.directory = directory
        self.max_segment_bytes = max(1 << 9, int(max_segment_bytes))
        self.obs = obs
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)  # writer wake
        self._durable_cv = threading.Condition(self._lock)
        self._pending: list[bytes] = []  # encoded payloads awaiting write
        # Replication tap: when set (ReplicationHub), called as
        # tap(seq, payload) under self._lock from append() — the lock
        # is what guarantees the stream sees seqs contiguous and in
        # order.  The tap must not call back into journal methods.
        self.tap = None
        self._policy = fsync_policy
        self._fsync_req = 0  # explicit fence target seq (WAIT / close)
        self._broken: Optional[BaseException] = None
        self._closed = False
        # fsync-latency model feeding the admission estimator (lag_s):
        # EWMA of fsync duration and records amortized per fsync.
        self._fsync_ewma_s = 0.0
        self._records_per_fsync = 1.0
        self._last_fsync = time.monotonic()
        self.fsyncs = 0  # lifetime fsync count (INFO persistence)
        self.bytes_written = 0
        self.records_written = 0
        if fresh:
            self._wipe_segments()
        self._segments: list[_Segment] = []
        self._recover_segments()
        # seqs are 1-based; _durable_seq/_written_seq trail _next_seq-1.
        last = self._segments[-1].last_seq if self._segments else 0
        self._next_seq = last + 1
        self._written_seq = last
        # Everything recovered from disk was (by definition) written;
        # durability of the recovered prefix is moot — recovery already
        # consumed it.  New appends start the durable clock fresh.
        self._durable_seq = last
        self._file = None
        self._open_tail_for_append()
        self._writer = threading.Thread(
            target=self._run, name="rtpu-journal", daemon=True
        )
        self._writer.start()

    # -- recovery-time scan ------------------------------------------------

    def _wipe_segments(self) -> None:
        for fn in sorted(os.listdir(self.directory)):
            if fn.startswith(_SEG_PREFIX) and fn.endswith(_SEG_SUFFIX):
                os.unlink(os.path.join(self.directory, fn))
        _fsync_dir(self.directory)

    def _recover_segments(self) -> None:
        """Scan segments in seq order; truncate at the first bad frame
        (torn tail) and discard everything after it — later segments
        cannot be trusted once the chain broke."""
        names = sorted(
            fn for fn in os.listdir(self.directory)
            if fn.startswith(_SEG_PREFIX) and fn.endswith(_SEG_SUFFIX)
        )
        expected: Optional[int] = None
        broken_at: Optional[int] = None
        for i, fn in enumerate(names):
            path = os.path.join(self.directory, fn)
            first_seq, frames, good_end, clean = _scan_segment(path)
            if first_seq is None or (
                expected is not None and first_seq != expected
            ):
                broken_at = i
                break
            self._segments.append(_Segment(path, first_seq, len(frames)))
            if not clean:
                # Torn tail: keep the good prefix, drop the rest of the
                # file and every later segment.
                with open(path, "r+b") as f:
                    f.truncate(good_end)
                    f.flush()
                    os.fsync(f.fileno())
                broken_at = i + 1
                break
            expected = first_seq + len(frames)
        if broken_at is not None:
            for fn in names[broken_at:]:
                os.unlink(os.path.join(self.directory, fn))
            _fsync_dir(self.directory)

    def _open_tail_for_append(self) -> None:
        """Append into the last scanned segment while it has room, else
        start a fresh one (also the empty-directory path)."""
        if self._segments:
            tail = self._segments[-1]
            if os.path.getsize(tail.path) < self.max_segment_bytes:
                self._file = open(tail.path, "ab")
                return
        self._start_segment_locked(self._next_seq)

    def _start_segment_locked(self, first_seq: int) -> None:
        path = _seg_path(self.directory, first_seq)
        f = open(path, "wb")
        f.write(_MAGIC + _HDR.pack(_VERSION, first_seq))
        f.flush()
        os.fsync(f.fileno())
        _fsync_dir(self.directory)
        self._segments.append(_Segment(path, first_seq, 0))
        self._file = f

    # -- replay access -----------------------------------------------------

    def records_after(self, seq: int) -> Iterator[tuple[int, dict]]:
        """(seq, record) for every record with seq > ``seq``, in order.
        Reads from disk — the scanned prefix is immutable while the
        writer only appends, so this is safe concurrently with appends
        (recovery runs it before any traffic anyway)."""
        for seg in list(self._segments):
            if seg.count == 0 or seg.last_seq <= seq:
                continue
            first_seq, frames, _end, _clean = _scan_segment(seg.path)
            if first_seq is None:
                return
            with open(seg.path, "rb") as f:
                for i, (off, plen) in enumerate(frames):
                    rseq = first_seq + i
                    if rseq <= seq:
                        continue
                    f.seek(off)
                    yield rseq, decode_record(f.read(plen))

    # -- producer side -----------------------------------------------------

    @property
    def policy(self) -> str:
        return self._policy

    def set_policy(self, policy: str) -> None:
        if policy not in FSYNC_POLICIES:
            raise ValueError(
                f"journal_fsync must be one of {FSYNC_POLICIES}, "
                f"got {policy!r}"
            )
        with self._lock:
            self._policy = policy
            self._cv.notify()

    def append(self, rec: dict) -> int:
        """Assign a seq and enqueue one record for the writer; returns
        the seq.  Producer-side cost is the encode + one lock — no I/O.
        Raises :class:`JournalError` once the journal is broken/closed
        (the op fails BEFORE it could be acked without durability)."""
        payload = encode_record(rec)
        with self._lock:
            if self._broken is not None:
                raise JournalError(
                    f"journal is broken: {self._broken}"
                ) from self._broken
            if self._closed:
                raise JournalError("journal is closed")
            seq = self._next_seq
            self._next_seq += 1
            self._pending.append(payload)
            if self.tap is not None:
                self.tap(seq, payload)
            self._cv.notify()
        return seq

    def cut(self) -> int:
        """Last assigned seq — the snapshot's consistency barrier.  The
        caller (snapshot()) holds the engine's journal gate, so no
        record can be appended between this read and the state capture."""
        with self._lock:
            return self._next_seq - 1

    def last_seq(self) -> int:
        return self.cut()

    def min_available_seq(self) -> int:
        """Smallest seq still readable from on-disk segments — the
        floor of the partial-resync disk fallback.  Snapshots retire
        covered segments, so this climbs over time; an offset below it
        can only be served by a FULLRESYNC."""
        with self._lock:
            for seg in self._segments:
                if seg.count:
                    return seg.first_seq
            return self._next_seq

    def durable_seq(self) -> int:
        with self._lock:
            return self._durable_seq

    def is_durable(self, seq: int) -> bool:
        with self._lock:
            return seq <= self._durable_seq

    def wait_durable(self, seq: Optional[int] = None,
                     timeout: Optional[float] = None) -> bool:
        """Block until record ``seq`` (default: everything appended so
        far) is fsynced — the WAIT fence.  Forces an explicit fsync
        under every policy (``no`` included: the fence is the one
        durability promise that policy still makes).  True on success,
        False on timeout; JournalError if the journal broke."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if seq is None:
                seq = self._next_seq - 1
            while seq > self._durable_seq:
                if self._broken is not None:
                    raise JournalError(
                        f"journal is broken: {self._broken}"
                    ) from self._broken
                if (
                    self._closed
                    and not self._pending
                    and seq > self._written_seq
                ):
                    # Closed with the record never written: it cannot
                    # become durable.  A WRITTEN record keeps waiting —
                    # close()'s final fsync covers it and notifies.
                    raise JournalError(
                        "journal closed before the record was written"
                    )
                if self._fsync_req < seq:
                    self._fsync_req = seq
                    self._cv.notify()
                wait = 0.5
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        return False
                    wait = min(wait, 0.5)
                self._durable_cv.wait(timeout=wait)
        return True

    def lag_ops(self) -> int:
        """Appended-but-not-yet-durable records (rtpu_journal_lag_ops)."""
        with self._lock:
            return self._next_seq - 1 - self._durable_seq

    def lag_s(self) -> float:
        """Estimated seconds until a NEW record becomes durable under
        ``always`` — rides the coalescer's admission estimate so a slow
        disk sheds deadline-carrying load instead of queueing it
        unboundedly.  0 under the other policies (acks don't wait)."""
        if self._policy != "always":
            return 0.0
        pending = self._next_seq - 1 - self._durable_seq  # racy read: ok
        if pending <= 0:
            return 0.0
        per_fsync = self._fsync_ewma_s
        if per_fsync <= 0.0:
            return 0.0
        batches = pending / max(1.0, self._records_per_fsync)
        return per_fsync * (batches + 1.0)

    # -- snapshot coordination ---------------------------------------------

    def mark_snapshot(self, upto_seq: int) -> int:
        """A snapshot covering every record with seq <= ``upto_seq`` is
        durable: rotate the live segment and retire every segment fully
        covered (the BGREWRITEAOF analog).  Returns retired-segment
        count.  Called OUTSIDE the engine locks — rotation synchronizes
        with the writer via the queue lock."""
        with self._lock:
            self._rotate_req = True
            self._cv.notify()
            # Wait for the writer to drain pending + rotate, so no
            # to-be-retired segment still has records in flight toward
            # it.  Bounded: a broken journal stops waiting.
            deadline = time.monotonic() + 30.0
            while (
                (self._pending or getattr(self, "_rotate_req", False))
                and self._broken is None
                and not self._closed
                and time.monotonic() < deadline
            ):
                self._durable_cv.wait(timeout=0.2)
            retire = [
                s for s in self._segments[:-1]
                if s.count == 0 or s.last_seq <= upto_seq
            ]
            self._segments = [
                s for s in self._segments if s not in retire
            ]
        for s in retire:
            try:
                os.unlink(s.path)
            except OSError:  # pragma: no cover — already gone
                pass
        if retire:
            _fsync_dir(self.directory)
        return len(retire)

    # -- stats (INFO persistence / gauges) ---------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "policy": self._policy,
                "last_seq": self._next_seq - 1,
                "durable_seq": self._durable_seq,
                "lag_ops": self._next_seq - 1 - self._durable_seq,
                "segments": len(self._segments),
                "bytes_written": self.bytes_written,
                "records_written": self.records_written,
                "fsyncs": self.fsyncs,
                "fsync_ewma_us": round(self._fsync_ewma_s * 1e6, 1),
                "broken": self._broken is not None,
            }

    # -- writer thread -----------------------------------------------------

    _rotate_req = False

    def _run(self) -> None:
        while True:
            with self._lock:
                timeout = 0.05
                if self._policy == "everysec":
                    due = self._last_fsync + 1.0 - time.monotonic()
                    timeout = min(timeout, max(0.005, due)) if due > 0 \
                        else 0.005
                if not (
                    self._pending
                    or self._closed
                    or self._rotate_req
                    or self._fsync_due_locked()
                ):
                    self._cv.wait(timeout=timeout)
                batch = self._pending
                self._pending = []
                closed = self._closed
                rotate = self._rotate_req
                policy = self._policy
                fence = self._fsync_req
            try:
                if batch:
                    self._write_batch(batch)
                want_fsync = (
                    rotate
                    or closed
                    or (batch and policy == "always")
                    or fence > self._durable_seq
                    or (
                        policy == "everysec"
                        # Written-but-unfsynced records exist and the
                        # window elapsed — batch or not (the batch that
                        # wrote them may be long gone).
                        and self._written_seq > self._durable_seq
                        and time.monotonic() - self._last_fsync >= 1.0
                    )
                )
                if want_fsync:
                    self._do_fsync()
                if rotate and self._rotate_req:
                    # Re-checked: a size-triggered rotation inside
                    # _write_batch may already have satisfied the
                    # request — rotating twice would register two
                    # segment entries for one path and let a retire
                    # unlink the live file.
                    self._rotate()
            except BaseException as e:
                self._break(e)
                return
            if closed:
                with self._lock:
                    if not self._pending:
                        try:
                            self._file.close()
                        except OSError:  # pragma: no cover
                            pass
                        self._durable_cv.notify_all()
                        return

    def _fsync_due_locked(self) -> bool:
        if self._fsync_req > self._durable_seq:
            return True
        return (
            self._policy == "everysec"
            and self._written_seq > self._durable_seq
            and time.monotonic() - self._last_fsync >= 1.0
        )

    def _write_batch(self, batch: list[bytes]) -> None:
        if _chaos.ENABLED:  # crash-fault point: the batch write
            _chaos.fire("journal.write")
        f = self._file
        nbytes = 0
        for payload in batch:
            frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
            if _chaos.ENABLED:
                try:
                    _chaos.fire("journal.torn_tail")
                except _chaos.FaultInjected as e:
                    # Simulated crash mid-frame: half the frame reaches
                    # the file, then the journal breaks — recovery must
                    # truncate here without touching earlier records.
                    f.write(frame[: max(1, len(frame) // 2)])
                    f.flush()
                    raise JournalError(
                        "torn tail injected at journal.torn_tail"
                    ) from e
            f.write(frame)
            nbytes += len(frame)
        f.flush()
        n = len(batch)
        with self._lock:
            self._written_seq += n
            self._segments[-1].count += n
            self.records_written += n
            self.bytes_written += nbytes
        obs = self.obs
        if obs is not None:
            obs.journal_records.inc((), n)
            obs.journal_bytes.inc((), nbytes)
        if os.path.getsize(self._segments[-1].path) >= \
                self.max_segment_bytes:
            self._do_fsync()
            self._rotate()

    def _do_fsync(self) -> None:
        t0 = time.monotonic()
        # Crash-fault point BEFORE the barrier; timed WITH the fsync so
        # an injected latency fault reads as a slow disk to the fsync
        # EWMA.
        if _chaos.ENABLED:
            _chaos.fire("journal.fsync")
        os.fsync(self._file.fileno())
        dt = time.monotonic() - t0
        with self._lock:
            newly = self._written_seq - self._durable_seq
            self._durable_seq = self._written_seq
            if self._fsync_req <= self._durable_seq:
                self._fsync_req = 0
            self._last_fsync = time.monotonic()
            self.fsyncs += 1
            self._fsync_ewma_s += 0.25 * (dt - self._fsync_ewma_s)
            if newly > 0:
                self._records_per_fsync += 0.25 * (
                    newly - self._records_per_fsync
                )
            self._durable_cv.notify_all()
        obs = self.obs
        if obs is not None:
            obs.journal_fsync_us.observe((), dt)

    def _rotate(self) -> None:
        """Close the live segment (already fsynced by the caller) and
        open a fresh one starting at the next seq.  An EMPTY live
        segment never rotates: the successor would share its first_seq
        (and filename), and a later retire of the stale entry would
        unlink the live file."""
        with self._lock:
            if self._segments and self._segments[-1].count == 0:
                self._rotate_req = False
                self._durable_cv.notify_all()
                return
            try:
                self._file.close()
            except OSError:  # pragma: no cover
                pass
            self._start_segment_locked(self._written_seq + 1)
            self._rotate_req = False
            self._durable_cv.notify_all()

    def _break(self, exc: BaseException) -> None:
        with self._lock:
            if self._broken is None:
                self._broken = exc
            self._durable_cv.notify_all()
            self._cv.notify_all()
        try:
            self._file.close()
        except OSError:  # pragma: no cover
            pass

    # -- lifecycle ---------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Drain pending records, final-fsync, stop the writer."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._writer.join(timeout=timeout)

    @property
    def broken(self) -> Optional[BaseException]:
        return self._broken
