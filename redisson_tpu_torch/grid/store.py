"""GridStore — the host keyspace behind the data-grid catalog.

Role parity: the Redis server's keyspace as seen through Redisson
(→ org/redisson/RedissonObject.java name addressing + RedissonExpirable
TTL): name → (kind, value, expire_at), with WRONGTYPE guards, lazy expiry
on access, and a background sweeper standing in for the reference's
``EvictionScheduler`` (→ org/redisson/eviction/, SURVEY.md §2.1).

All mutation happens under one re-entrant lock; blocking collection ops
wait on a condition tied to that lock (the pub/sub-wakeup analog of
BLPOP, → SURVEY.md §3.3).

The port's copy of ``redisson_tpu/grid/store.py``.  The snapshot codec
covers every kind the JAX package persists, so a ``grid_store.bin``
written by either package restores into the other and is written back
byte for byte.  Mutations reach the op journal as full-state
``grid.state``/``grid.del`` records (``on_journal`` hooks, wired by the
client); the load-map keyspace hook waits for that subsystem.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from typing import Any, Callable, Optional


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable."""
    import os

    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class GridEntry:
    __slots__ = ("kind", "value", "expire_at")

    def __init__(self, kind: str, value: Any):
        self.kind = kind
        self.value = value
        self.expire_at: Optional[float] = None  # epoch seconds

    def expired(self, now: float) -> bool:
        return self.expire_at is not None and now >= self.expire_at


class GridStore:
    SWEEP_INTERVAL_S = 0.25

    def __init__(self):
        self.lock = threading.RLock()
        self.cond = threading.Condition(self.lock)
        self._data: dict[str, GridEntry] = {}
        self._sweeper: Optional[threading.Thread] = None
        self._closed = False
        # Wired by the client to the sketch engine's ``probe``: the user
        # sees ONE keyspace, so creating a grid object under a name held by
        # the other backend is the WRONGTYPE error, not a shadow copy.
        # The probe MUST be lock-free and side-effect-free on the foreign
        # backend — each side calls it while holding its own lock, so a
        # locking probe would be an AB-BA deadlock.
        self.foreign_exists = None
        # Near-cache reach: the client wires these to the engine near
        # cache's grid-tenant invalidation, so store-level identity
        # changes (delete / rename / expiry / snapshot restore) retire
        # cached grid scalars the per-object mutators can't see.  Both
        # must be leaf-safe: they are called under ``self.lock``.
        self.on_invalidate = None
        self.on_invalidate_all = None
        # Op-journal reach: the client wires these to the sketch engine's
        # journal seam so grid mutations enter the SAME total order the
        # replication stream ships.  Grid records are full-entry-state
        # (idempotent, last-write-wins on replay), captured+appended
        # atomically under ``self.lock`` — so seq order equals capture
        # order and the highest seq for a name carries its newest state.
        # ``on_journal(op, name, **fields) -> seq|None`` is called under
        # the lock (it only takes the journal's queue lock — ordering
        # grid.store → journal.queue, never reversed);
        # ``on_journal_ack(seq)`` is called OUTSIDE it (under
        # appendfsync=always it blocks on the fsync fence).
        self.on_journal = None
        self.on_journal_ack = None
        # ``journal_live() -> bool``, wired with the hooks: whether a
        # journal is attached right now (CONFIG SET appendonly switches
        # it live).  A capture encodes the object's whole state, so with
        # the journal off it must not run at all.
        self.journal_live = None
        # True while applying replicated/replayed records: the apply
        # path must never re-journal what it applies.
        self.journal_suspended = False

    def _note_invalidate(self, name: str) -> None:
        hook = self.on_invalidate
        if hook is not None:
            hook(name)

    # -- op-journal capture/apply ------------------------------------------

    @staticmethod
    def _pack_blobs(blobs) -> bytes:
        """Length-prefixed blob list as one bytes field (the record
        codec ships bytes as a uint8 array)."""
        import struct

        parts = [struct.pack("<I", len(blobs))]
        for b in blobs:
            parts.append(struct.pack("<I", len(b)))
            parts.append(bytes(b))
        return b"".join(parts)

    @staticmethod
    def _unpack_blobs(data) -> list:
        import struct

        if hasattr(data, "tobytes"):  # decoded records carry uint8 arrays
            data = data.tobytes()
        (n,) = struct.unpack_from("<I", data, 0)
        off = 4
        out = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", data, off)
            off += 4
            out.append(bytes(data[off : off + ln]))
            off += ln
        if len(out) != n:
            raise ValueError("truncated grid blob pack")
        return out

    def journal_active(self) -> bool:
        """True while grid mutations must be journaled: the hooks are
        wired, a journal is attached and this is not a replay."""
        live = self.journal_live
        return (
            self.on_journal is not None and not self.journal_suspended
            and live is not None and live()
        )

    def _journal_capture(self, name: str):
        """Append one full-state record for ``name`` as it stands RIGHT
        NOW (a ``grid.del`` when absent/expired) and return the seq.
        MUST run under ``self.lock`` — capture+append atomicity is what
        makes seq order equal state order.  None when journaling is off
        (no encode then), suspended, or the kind has no codec (such kinds don't snapshot
        either, so replicas/recovery can't see them anyway)."""
        if not self.journal_active():
            return None
        hook = self.on_journal
        e = self._data.get(name)
        if e is None or e.expired(time.time()):
            return hook("grid.del", name)
        blobs: list = []

        def add_blob(b) -> int:
            blobs.append(bytes(b))
            return len(blobs) - 1

        desc = self._enc_entry(e.kind, e.value, add_blob)
        if desc is None:
            return None
        import json

        return hook(
            "grid.state", name,
            kind=e.kind,
            desc=json.dumps(desc, separators=(",", ":")),
            expire_at=e.expire_at,
            blobs=self._pack_blobs(blobs),
        )

    def _journal_ack(self, seq) -> None:
        """Durability fence for a captured record — call OUTSIDE the
        store lock (blocks on fsync under appendfsync=always)."""
        ack = self.on_journal_ack
        if ack is not None and seq is not None:
            ack(seq)

    def journal_entry(self, name: str) -> None:
        """Capture + ack one name's state: the per-mutator hook the
        ``journaled`` decorator (grid/base.py) calls after a mutation
        returns."""
        with self.lock:
            seq = self._journal_capture(name)
        self._journal_ack(seq)

    def apply_journal_record(self, rec: dict) -> None:
        """Install one ``grid.state``/``grid.del`` record — the replica
        stream-apply and journal-recovery entry point.  Full-state
        semantics: idempotent, latest-seq-wins."""
        op = rec["op"]
        name = rec["name"]
        prev = self.journal_suspended
        self.journal_suspended = True
        try:
            if op == "grid.del":
                self.delete(name)
                return
            if op != "grid.state":
                raise ValueError(f"not a grid journal record: {op!r}")
            import json

            blobs = self._unpack_blobs(rec["blobs"])
            value = self._dec_entry(json.loads(rec["desc"]), blobs)
            exp = rec.get("expire_at")
            with self.lock:
                e = GridEntry(str(rec["kind"]), value)
                e.expire_at = exp
                self._data[name] = e
                self._note_invalidate(name)
                if exp is not None:
                    self._ensure_sweeper()
                self.cond.notify_all()
        finally:
            self.journal_suspended = prev

    def _guard_foreign(self, name: str) -> None:
        if self.foreign_exists is not None and self.foreign_exists(name):
            raise TypeError(
                f"object {name!r} is held by the sketch backend (WRONGTYPE)"
            )

    def probe(self, name: str) -> bool:
        """Lock-free existence probe for the sketch backend's guard (dict
        reads are atomic in CPython; expiry checked without reaping)."""
        e = self._data.get(name)
        return e is not None and not e.expired(time.time())

    # -- entry access ------------------------------------------------------

    def get_entry(self, name: str, kind: Optional[str] = None) -> Optional[GridEntry]:
        """Live entry or None; raises TypeError on kind mismatch (the Redis
        WRONGTYPE analog).  Caller must hold ``self.lock`` for compound
        read-modify-write sequences."""
        with self.lock:
            e = self._data.get(name)
            if e is not None and e.expired(time.time()):
                del self._data[name]
                self._note_invalidate(name)
                e = None
            if e is not None and kind is not None and e.kind != kind:
                raise TypeError(f"object {name!r} holds a {e.kind}, not a {kind}")
            return e

    def ensure_entry(self, name: str, kind: str, factory: Callable[[], Any]) -> GridEntry:
        with self.lock:
            e = self.get_entry(name, kind)
            if e is None:
                self._guard_foreign(name)
                e = GridEntry(kind, factory())
                self._data[name] = e
            return e

    def put_entry(self, name: str, kind: str, value: Any) -> GridEntry:
        with self.lock:
            prior = self._data.get(name)
            if prior is None or prior.expired(time.time()):
                # An expired-unswept entry confers NO ownership: probe()
                # already reports the name absent to the sketch side,
                # which may have legitimately created it meanwhile.
                self._guard_foreign(name)
            e = GridEntry(kind, value)
            self._data[name] = e
            self.cond.notify_all()
            return e

    def notify(self) -> None:
        """Wake blocked takers after a mutation (BLPOP-wakeup analog)."""
        with self.lock:
            self.cond.notify_all()

    # -- keyspace admin (RKeys backing) ------------------------------------

    def exists(self, name: str) -> bool:
        return self.get_entry(name) is not None

    def delete(self, name: str) -> bool:
        with self.lock:
            e = self.get_entry(name)
            if e is None:
                return False
            del self._data[name]
            self._note_invalidate(name)
            self.cond.notify_all()
            seq = self._journal_capture(name)
        self._journal_ack(seq)
        return True

    def rename(self, old: str, new: str) -> bool:
        with self.lock:
            e = self.get_entry(old)
            if e is None:
                return False
            if old == new:
                return True  # RENAME key key succeeds when the key exists
            # One logical keyspace: renaming ONTO a sketch-held name would
            # leave it live on both backends.
            self._guard_foreign(new)
            del self._data[old]
            self._data[new] = e
            self._note_invalidate(old)
            self._note_invalidate(new)
            # Two full-state records (old absent, new present) — rename
            # needs no record type of its own under last-write-wins.
            self._journal_capture(old)
            seq = self._journal_capture(new)
        self._journal_ack(seq)
        return True

    def names(self, pattern: Optional[str] = None) -> list[str]:
        with self.lock:
            now = time.time()
            out = []
            for n, e in list(self._data.items()):
                if e.expired(now):
                    del self._data[n]
                    self._note_invalidate(n)
                    continue
                if pattern is None or fnmatch.fnmatchcase(n, pattern):
                    out.append(n)
            return out

    # -- TTL (RedissonExpirable parity) ------------------------------------

    def expire(self, name: str, ttl_s: float) -> bool:
        with self.lock:
            e = self.get_entry(name)
            if e is None:
                return False
            e.expire_at = time.time() + ttl_s
            self._note_invalidate(name)
            self._ensure_sweeper()
            seq = self._journal_capture(name)
        self._journal_ack(seq)
        return True

    def expire_at(self, name: str, epoch_s: float) -> bool:
        with self.lock:
            e = self.get_entry(name)
            if e is None:
                return False
            e.expire_at = float(epoch_s)
            self._note_invalidate(name)
            self._ensure_sweeper()
            seq = self._journal_capture(name)
        self._journal_ack(seq)
        return True

    def clear_expire(self, name: str) -> bool:
        with self.lock:
            e = self.get_entry(name)
            if e is None or e.expire_at is None:
                return False
            e.expire_at = None
            self._note_invalidate(name)
            seq = self._journal_capture(name)
        self._journal_ack(seq)
        return True

    def remain_ttl_ms(self, name: str) -> int:
        """→ RExpirable#remainTimeToLive: -2 absent, -1 no TTL, else ms."""
        with self.lock:
            e = self.get_entry(name)
            if e is None:
                return -2
            if e.expire_at is None:
                return -1
            return max(0, int((e.expire_at - time.time()) * 1000))

    # -- sweeper (EvictionScheduler analog) --------------------------------

    def peek_expire_at(self, name: str):
        """The entry's TTL deadline (or None) WITHOUT reaping — the
        near-cache reach tags cached scalars with it so a hit can
        observe the deadline exactly, not at the next sweep."""
        with self.lock:
            e = self._data.get(name)
            return None if e is None else e.expire_at

    def _ensure_sweeper(self) -> None:
        if self._sweeper is None or not self._sweeper.is_alive():
            self._sweeper = threading.Thread(
                target=self._sweep_loop, name="rtpu-grid-sweeper", daemon=True
            )
            self._sweeper.start()

    def _sweep_loop(self) -> None:
        while not self._closed:
            time.sleep(self.SWEEP_INTERVAL_S)
            now = time.time()
            with self.lock:
                dead = [n for n, e in self._data.items() if e.expired(now)]
                for n in dead:
                    del self._data[n]
                    self._note_invalidate(n)
                if dead:
                    self.cond.notify_all()
                # Let map-entry TTL structures prune themselves too.
                for e in self._data.values():
                    pruner = getattr(e.value, "prune_expired", None)
                    if pruner is not None:
                        pruner(now)

    def shutdown(self) -> None:
        self._closed = True

    # -- persistence (the RDB-analog for the HOST keyspace; sketch pools
    # snapshot separately in objects/durability.py).  DATA-ONLY wire
    # format — no pickle (snapshots may be moved between machines):
    # RTPG | u32 meta_len | json meta | u32-length-prefixed blobs.
    # Values reference blobs by index.  Persisted kinds: bucket,
    # binarystream, set, setcache, zset, lexset, map, mapcache, list
    # (queues/deques share it), ringbuffer, atomic counters/adders,
    # idgenerator, stream (entries + consumer groups/PELs — the
    # replication stream needs full stream state).  NOT
    # persisted (skipped with a summary warning): coordination state
    # (locks, latches, semaphores), delayed/priority queues, geo,
    # timeseries, multimaps, and sortedset (its in-memory order is
    # codec-decoded, which the store cannot rebuild).  The same codec
    # backs per-mutation ``grid.state`` journal records — an
    # unsupported kind is skipped in BOTH tiers, so replicas and
    # recovery stay consistent with snapshots.
    # ----------------------------------------------------------------------

    _SNAP_MAGIC = b"RTPG"
    _SNAP_VERSION = 1

    @staticmethod
    def _enc_entry(kind: str, value, add_blob):
        """-> JSON-safe value descriptor, or None if kind unsupported."""
        if kind in ("bucket", "binarystream"):
            if value is None:
                return {"t": "none"}
            if isinstance(value, str):  # legacy str bucket payloads
                value = value.encode()
            if not isinstance(value, bytes):
                return None
            return {"t": "b", "v": add_blob(value)}
        if kind == "set":
            return {"t": "set", "m": [add_blob(vb) for vb in value]}
        if kind == "setcache":
            return {
                "t": "setc",
                "m": [[add_blob(vb), exp] for vb, exp in value.data.items()],
            }
        if kind == "zset":
            return {
                "t": "zset",
                "m": [[add_blob(vb), s] for vb, s in value.items()],
            }
        if kind == "lexset":
            return {"t": "lex", "m": sorted(value)}
        if kind in ("map", "mapcache"):
            now = time.time()
            rows = []
            for kb, slot in value.data.items():
                vb, exp, idle, last = slot
                elapsed = now - last
                if idle is not None and elapsed >= idle:
                    continue  # idle-dead at snapshot time: do not resurrect
                rows.append(
                    [add_blob(kb), add_blob(vb), exp, idle, elapsed]
                )
            return {"t": "map", "m": rows}
        if kind == "list":
            return {"t": "list", "m": [add_blob(vb) for vb in value]}
        if kind in ("atomiclong", "atomicdouble", "longadder", "doubleadder"):
            return {"t": "num", "v": value}
        if kind == "idgenerator":
            return {"t": "idgen", "next": value["next"], "block": value["block"]}
        if kind == "ringbuffer":
            return {
                "t": "ring",
                "cap": value["cap"],
                "m": [add_blob(vb) for vb in value["items"]],
            }
        if kind == "stream":
            # Full _StreamValue state incl. consumer groups and PELs —
            # required by the replication stream: XADD on a
            # primary must materialize on its replicas.
            rows = [
                [ms, sq,
                 [[add_blob(fk), add_blob(fv)] for fk, fv in fields.items()]]
                for (ms, sq), fields in value.entries.items()
            ]
            groups = [
                {
                    "n": gname,
                    "ld": list(g["last_delivered"]),
                    "p": [
                        [ms, sq, p["consumer"], p["time_ms"], p["count"]]
                        for (ms, sq), p in g["pending"].items()
                    ],
                    "c": sorted(g["consumers"]),
                }
                for gname, g in value.groups.items()
            ]
            return {
                "t": "stream",
                "m": rows,
                "last": list(value.last_id),
                "maxdel": list(value.max_deleted_id),
                "added": value.added,
                "g": groups,
            }
        return None

    @staticmethod
    def _dec_entry(desc: dict, blobs):
        t = desc["t"]
        if t == "none":
            return None
        if t == "b":
            return blobs[desc["v"]]
        if t == "set":
            return {blobs[i]: None for i in desc["m"]}
        if t == "setc":
            from redisson_tpu_torch.grid.collections import SetCache

            v = SetCache._Value()
            v.data = {blobs[i]: exp for i, exp in desc["m"]}
            return v
        if t == "zset":
            return {blobs[i]: float(s) for i, s in desc["m"]}
        if t == "lex":
            return set(desc["m"])
        if t == "map":
            from redisson_tpu_torch.grid.maps import _MapValue

            v = _MapValue()
            now = time.time()
            # last_access carries over as ELAPSED idle: an entry that had
            # burned 40s of a 60s max-idle window resumes with 20s left,
            # not a fresh window (RMapCache max-idle contract).
            v.data = {
                blobs[ki]: [blobs[vi], exp, idle, now - elapsed]
                for ki, vi, exp, idle, elapsed in desc["m"]
            }
            return v
        if t == "list":
            return [blobs[i] for i in desc["m"]]
        if t == "num":
            return desc["v"]
        if t == "idgen":
            return {"next": int(desc["next"]), "block": int(desc["block"])}
        if t == "ring":
            return {"cap": int(desc["cap"]), "items": [blobs[i] for i in desc["m"]]}
        if t == "stream":
            from redisson_tpu_torch.grid.streams import _StreamValue

            v = _StreamValue()
            v.entries = {
                (int(ms), int(sq)): {blobs[ki]: blobs[vi] for ki, vi in fm}
                for ms, sq, fm in desc["m"]
            }
            v.last_id = tuple(int(x) for x in desc["last"])
            v.max_deleted_id = tuple(int(x) for x in desc["maxdel"])
            v.added = int(desc["added"])
            v.groups = {
                g["n"]: {
                    "last_delivered": tuple(int(x) for x in g["ld"]),
                    "pending": {
                        (int(ms), int(sq)): {
                            "consumer": cons,
                            "time_ms": int(tms),
                            "count": int(cnt),
                        }
                        for ms, sq, cons, tms, cnt in g["p"]
                    },
                    "consumers": set(g["c"]),
                }
                for g in desc["g"]
            }
            return v
        raise ValueError(f"unknown grid snapshot value type {t!r}")

    def snapshot_to(self, path: str) -> int:
        """Write every persistable live entry; returns the count written.
        Atomic (tmp + rename)."""
        import io
        import json
        import os
        import struct

        blobs: list[bytes] = []

        def add_blob(b: bytes) -> int:
            blobs.append(bytes(b))
            return len(blobs) - 1

        meta = []
        skipped: dict[str, int] = {}
        now = time.time()
        with self.lock:
            for name, e in self._data.items():
                if e.expired(now):
                    continue
                desc = self._enc_entry(e.kind, e.value, add_blob)
                if desc is None:
                    skipped[e.kind] = skipped.get(e.kind, 0) + 1
                    continue
                meta.append(
                    {
                        "name": name,
                        "kind": e.kind,
                        "expire_at": e.expire_at,
                        "value": desc,
                    }
                )
        if skipped:
            import logging

            logging.getLogger(__name__).warning(
                "grid snapshot skipped non-persisted kinds: %s", skipped
            )
        header = json.dumps({"v": self._SNAP_VERSION, "entries": meta}).encode()
        buf = io.BytesIO()
        buf.write(self._SNAP_MAGIC)
        buf.write(struct.pack("<I", len(header)))
        buf.write(header)
        for b in blobs:
            buf.write(struct.pack("<I", len(b)))
            buf.write(b)
        import uuid

        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        # Unique per WRITER (not just per process): the shutdown writer
        # and the periodic snapshotter thread may race on the same path;
        # identical tmp names would truncate each other mid-write.
        tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
            f.flush()
            # fsync-then-rename (RT014): without the barrier a host
            # crash can publish the snapshot NAME over void bytes —
            # restore_from would then load a torn grid snapshot where
            # the pre-rename file was still intact.
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(parent)
        return len(meta)

    def restore_from(self, path: str) -> bool:
        """Load a snapshot written by ``snapshot_to``; True if one was
        found.  Intended at init (empty keyspace); existing names are
        overwritten (same-name restore-on-boot semantics as the sketch
        side's empty-keyspace contract, enforced by call order)."""
        import json
        import os
        import struct

        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != self._SNAP_MAGIC:
            raise ValueError("not a grid snapshot (bad magic)")
        (hlen,) = struct.unpack("<I", data[4:8])
        head = json.loads(data[8 : 8 + hlen].decode())
        if head.get("v") != self._SNAP_VERSION:
            raise ValueError(f"unsupported grid snapshot v{head.get('v')}")
        # Whole-keyspace replacement: every cached grid scalar predates
        # the restored state (near-cache reach).
        hook = self.on_invalidate_all
        if hook is not None:
            hook()
        blobs: list[bytes] = []
        off = 8 + hlen
        while off < len(data):
            (n,) = struct.unpack("<I", data[off : off + 4])
            off += 4
            if off + n > len(data):
                raise ValueError("truncated grid snapshot blob")
            blobs.append(data[off : off + n])
            off += n
        now = time.time()
        clashes = []
        with self.lock:
            for ent in head["entries"]:
                exp = ent.get("expire_at")
                if exp is not None and now >= exp:
                    continue  # expired while on disk
                if self.foreign_exists is not None and self.foreign_exists(
                    ent["name"]
                ):
                    # The sketch and grid halves snapshot at different
                    # instants; a name that moved between backends in that
                    # window must not end up live on BOTH (the one-
                    # logical-keyspace invariant).  Sketch wins: it was
                    # captured under the engine locks.
                    clashes.append(ent["name"])
                    continue
                ge = GridEntry(ent["kind"], self._dec_entry(ent["value"], blobs))
                ge.expire_at = exp
                self._data[ent["name"]] = ge
                if exp is not None:
                    self._ensure_sweeper()
            self.cond.notify_all()
        if clashes:
            import logging

            logging.getLogger(__name__).warning(
                "grid restore skipped %d name(s) held by the sketch "
                "backend (snapshot halves raced): %s",
                len(clashes), clashes[:5],
            )
        return True
