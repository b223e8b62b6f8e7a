"""RStream — → org/redisson/RedissonStream.java over the Redis stream
command family (XADD/XRANGE/XREAD/XGROUP/XREADGROUP/XACK/XPENDING/XCLAIM/
XTRIM, SURVEY.md §2.3 streams row): append-only log of field-map entries
with (ms, seq) ids, consumer groups with per-entry pending lists (PEL),
acks, idle-based claims.

Entry ids are strings "ms-seq" (Redis wire shape); internally (ms, seq)
tuples order the log.  Field maps are codec-encoded per field/value, so
round-trip semantics match the reference's codec behavior.

The port's copy of ``redisson_tpu/grid/streams.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Iterable, Optional

from redisson_tpu_torch.grid.base import GridObject, journaled


def _parse_id(s, *, default_seq: int = 0) -> tuple[int, int]:
    if isinstance(s, tuple):
        return s
    if s == "-":
        return (0, 0)
    if s == "+":
        return (2**63 - 1, 2**63 - 1)
    if "-" in str(s):
        ms, seq = str(s).split("-", 1)
        return (int(ms), int(seq))
    return (int(s), default_seq)


def _fmt_id(t: tuple[int, int]) -> str:
    return f"{t[0]}-{t[1]}"


class _StreamValue:
    __slots__ = ("entries", "last_id", "groups", "max_deleted_id", "added")

    def __init__(self):
        self.entries: dict[tuple, dict] = {}  # insertion-ordered by id
        self.last_id: tuple = (0, 0)
        self.groups: dict[str, dict] = {}
        self.max_deleted_id: tuple = (0, 0)
        self.added = 0  # entries-added counter (XINFO entries-added)


@journaled("add", "trim", "remove", "create_group", "remove_group",
           "read_group", "ack", "claim", "auto_claim")
class Stream(GridObject):
    KIND = "stream"

    @staticmethod
    def _new_value():
        return _StreamValue()

    # -- XADD / XDEL / XTRIM ----------------------------------------------

    def add(self, entries: dict, id: str = "*", *,
            maxlen: Optional[int] = None, nomkstream: bool = False) -> Optional[str]:
        """→ XADD.  ``entries``: field→value map; ``id="*"`` auto-assigns
        (ms, seq).  Returns the new entry id, or None with ``nomkstream``
        on a missing stream."""
        if not entries:
            raise ValueError("stream entry needs at least one field")
        with self._store.lock:
            if nomkstream and self._entry(create=False) is None:
                return None
            e = self._entry()
            st: _StreamValue = e.value
            if id == "*":
                ms = int(time.time() * 1000)
                if ms > st.last_id[0]:
                    new_id = (ms, 0)
                else:  # clock went backwards / same ms: bump seq
                    new_id = (st.last_id[0], st.last_id[1] + 1)
            else:
                new_id = _parse_id(id)
                if new_id <= st.last_id:
                    raise ValueError(
                        "XADD id must be greater than the stream's last id"
                    )
            st.entries[new_id] = {
                self._enc_key(k): self._enc(v) for k, v in entries.items()
            }
            st.last_id = new_id
            st.added += 1
            if maxlen is not None:
                self._trim_locked(st, maxlen)
            self._nc_bump()  # XLEN-class cached scalars retire
            self._store.cond.notify_all()  # wake blocked readers
            return _fmt_id(new_id)

    def _trim_locked(self, st: _StreamValue, maxlen: int) -> int:
        n = 0
        while len(st.entries) > maxlen:
            oldest = next(iter(st.entries))
            del st.entries[oldest]
            st.max_deleted_id = max(st.max_deleted_id, oldest)
            n += 1
        return n

    def trim(self, maxlen: int) -> int:
        """→ XTRIM MAXLEN: number of evicted entries."""
        with self._store.lock:
            e = self._entry(create=False)
            n = 0 if e is None else self._trim_locked(e.value, maxlen)
            if n:
                self._nc_bump()
            return n

    def remove(self, *ids: str) -> int:
        """→ XDEL."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return 0
            st: _StreamValue = e.value
            n = 0
            for s in ids:
                t = _parse_id(s)
                if st.entries.pop(t, None) is not None:
                    st.max_deleted_id = max(st.max_deleted_id, t)
                    n += 1
            if n:
                self._nc_bump()
            return n

    # -- reads -------------------------------------------------------------

    def _decode(self, fields: dict) -> dict:
        return {self._dec_key(k): self._dec(v) for k, v in fields.items()}

    def size(self) -> int:
        """→ XLEN.  Rides the engine near cache:
        the hottest stream-length polls answer from the host tier
        without the grid lock."""

        def compute():
            with self._store.lock:
                e = self._entry(create=False)
                return 0 if e is None else len(e.value.entries)

        return self._nc_scalar("stream", ("xlen",), compute)

    def range(self, start: str = "-", end: str = "+",
              count: Optional[int] = None) -> list:
        """→ XRANGE: [(id, fields)] ascending."""
        lo, hi = _parse_id(start), _parse_id(end, default_seq=2**63 - 1)
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            out = [
                (_fmt_id(t), self._decode(f))
                for t, f in e.value.entries.items()
                if lo <= t <= hi
            ]
            return out if count is None else out[:count]

    def rev_range(self, start: str = "+", end: str = "-",
                  count: Optional[int] = None) -> list:
        """→ XREVRANGE: descending."""
        out = self.range(end, start)
        out.reverse()
        return out if count is None else out[:count]

    def read(self, from_id: str = "0-0", count: Optional[int] = None,
             block_seconds: Optional[float] = None) -> list:
        """→ XREAD [BLOCK]: entries with id STRICTLY greater than
        ``from_id`` ("$" = only entries added after this call)."""
        with self._store.cond:
            if from_id == "$":
                e = self._entry(create=False)
                after = e.value.last_id if e is not None else (0, 0)
            else:
                after = _parse_id(from_id)
            deadline = (
                None if block_seconds is None else time.monotonic() + block_seconds
            )
            while True:
                e = self._entry(create=False)
                if e is not None:
                    out = [
                        (_fmt_id(t), self._decode(f))
                        for t, f in e.value.entries.items()
                        if t > after
                    ]
                    if out:
                        return out if count is None else out[:count]
                if deadline is None:
                    return []
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._store.cond.wait(timeout=min(remaining, 1.0))

    def get(self, id: str) -> Optional[dict]:
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return None
            f = e.value.entries.get(_parse_id(id))
            return None if f is None else self._decode(f)

    def last_id(self) -> str:
        with self._store.lock:
            e = self._entry(create=False)
            return _fmt_id(e.value.last_id if e is not None else (0, 0))

    # -- consumer groups ---------------------------------------------------

    def create_group(self, group: str, from_id: str = "$",
                     mkstream: bool = True) -> None:
        """→ XGROUP CREATE."""
        with self._store.lock:
            e = self._entry(create=mkstream)
            if e is None:
                raise RuntimeError(f"stream {self._name!r} does not exist")
            st: _StreamValue = e.value
            if group in st.groups:
                raise ValueError(f"BUSYGROUP: group {group!r} already exists")
            last = st.last_id if from_id == "$" else _parse_id(from_id)
            st.groups[group] = {
                "last_delivered": last,
                "pending": {},  # id -> {consumer, time_ms, count}
                "consumers": set(),
            }

    def remove_group(self, group: str) -> bool:
        """→ XGROUP DESTROY."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return False
            return e.value.groups.pop(group, None) is not None

    def list_groups(self) -> list[dict]:
        """→ XINFO GROUPS."""
        with self._store.lock:
            e = self._entry(create=False)
            if e is None:
                return []
            return [
                {
                    "name": g,
                    "consumers": len(d["consumers"]),
                    "pending": len(d["pending"]),
                    "last_delivered_id": _fmt_id(d["last_delivered"]),
                }
                for g, d in e.value.groups.items()
            ]

    def list_consumers(self, group: str) -> list[dict]:
        """→ XINFO CONSUMERS."""
        with self._store.lock:
            g = self._group(group)
            per = {c: 0 for c in g["consumers"]}
            for p in g["pending"].values():
                per[p["consumer"]] = per.get(p["consumer"], 0) + 1
            return [{"name": c, "pending": n} for c, n in per.items()]

    def _group(self, group: str) -> dict:
        e = self._entry(create=False)
        if e is None or group not in e.value.groups:
            raise ValueError(f"NOGROUP: no such group {group!r}")
        return e.value.groups[group]

    def read_group(self, group: str, consumer: str,
                   count: Optional[int] = None, ids: str = ">",
                   block_seconds: Optional[float] = None,
                   noack: bool = False) -> list:
        """→ XREADGROUP: ``ids=">"`` delivers NEW entries (advancing the
        group cursor and adding to the consumer's PEL — unless ``noack``,
        the XREADGROUP NOACK contract: delivered entries skip the PEL
        entirely); an explicit id re-reads this consumer's pending
        entries after it."""
        deadline = (
            None if block_seconds is None else time.monotonic() + block_seconds
        )
        with self._store.cond:
            while True:
                g = self._group(group)
                g["consumers"].add(consumer)
                e = self._entry(create=False)
                st: _StreamValue = e.value
                now_ms = int(time.time() * 1000)
                if ids == ">":
                    out = []
                    for t, f in st.entries.items():
                        if t > g["last_delivered"]:
                            out.append((_fmt_id(t), self._decode(f)))
                            if not noack:
                                g["pending"][t] = {
                                    "consumer": consumer,
                                    "time_ms": now_ms,
                                    "count": 1,
                                }
                            g["last_delivered"] = t
                            if count is not None and len(out) >= count:
                                break
                    if out or deadline is None:
                        return out
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                    self._store.cond.wait(timeout=min(remaining, 1.0))
                    continue
                after = _parse_id(ids)
                out = []
                for t, p in sorted(g["pending"].items()):
                    if t > after and p["consumer"] == consumer:
                        f = st.entries.get(t)
                        if f is None:
                            continue  # XDEL'd while pending
                        p["count"] += 1
                        out.append((_fmt_id(t), self._decode(f)))
                        if count is not None and len(out) >= count:
                            break
                return out

    def ack(self, group: str, *ids: str) -> int:
        """→ XACK."""
        with self._store.lock:
            g = self._group(group)
            n = 0
            for s in ids:
                if g["pending"].pop(_parse_id(s), None) is not None:
                    n += 1
            return n

    def pending(self, group: str) -> dict:
        """→ XPENDING summary: total + per-consumer counts + id range."""
        with self._store.lock:
            g = self._group(group)
            per: dict[str, int] = {}
            for p in g["pending"].values():
                per[p["consumer"]] = per.get(p["consumer"], 0) + 1
            ids = sorted(g["pending"])
            return {
                "total": len(ids),
                "lowest_id": _fmt_id(ids[0]) if ids else None,
                "highest_id": _fmt_id(ids[-1]) if ids else None,
                "consumers": per,
            }

    def pending_range(self, group: str, start: str = "-", end: str = "+",
                      count: Optional[int] = None,
                      consumer: Optional[str] = None) -> list[dict]:
        """→ XPENDING with range: [{id, consumer, idle_ms, delivered}]."""
        lo, hi = _parse_id(start), _parse_id(end, default_seq=2**63 - 1)
        now_ms = int(time.time() * 1000)
        with self._store.lock:
            g = self._group(group)
            out = []
            for t in sorted(g["pending"]):
                if not (lo <= t <= hi):
                    continue
                p = g["pending"][t]
                if consumer is not None and p["consumer"] != consumer:
                    continue
                out.append(
                    {
                        "id": _fmt_id(t),
                        "consumer": p["consumer"],
                        "idle_ms": now_ms - p["time_ms"],
                        "delivered": p["count"],
                    }
                )
                if count is not None and len(out) >= count:
                    break
            return out

    def claim(self, group: str, consumer: str, min_idle_ms: int,
              *ids: str) -> list:
        """→ XCLAIM: transfer ownership of idle pending entries; returns
        the claimed [(id, fields)]."""
        now_ms = int(time.time() * 1000)
        with self._store.lock:
            g = self._group(group)
            e = self._entry(create=False)
            st: _StreamValue = e.value
            g["consumers"].add(consumer)
            out = []
            for s in ids:
                t = _parse_id(s)
                p = g["pending"].get(t)
                if p is None or now_ms - p["time_ms"] < min_idle_ms:
                    continue
                f = st.entries.get(t)
                if f is None:  # deleted entry: drop from PEL (Redis 6.2+)
                    del g["pending"][t]
                    continue
                p.update(consumer=consumer, time_ms=now_ms)
                p["count"] += 1
                out.append((_fmt_id(t), self._decode(f)))
            return out

    def auto_claim(self, group: str, consumer: str, min_idle_ms: int,
                   start: str = "0-0", count: int = 100,
                   with_cursor: bool = False, justid: bool = False):
        """→ XAUTOCLAIM: claim up to ``count`` idle entries from ``start``.
        Ownership transfers ONLY for entries actually returned — claiming
        is done under one lock pass that stops at ``count``, so no entry
        is silently reassigned (and its idle clock reset) invisibly.
        ``with_cursor`` additionally returns the Redis next-cursor — the
        id to continue from when COUNT truncated the sweep, '0-0' when
        the whole PEL was examined (callers looping until 0-0 must not
        be told a truncated sweep was exhaustive) — plus the ids DELETED
        from the PEL during the sweep (entries removed from the stream
        since delivery), the third element of the XAUTOCLAIM reply."""
        now_ms = int(time.time() * 1000)
        lo = _parse_id(start)
        with self._store.lock:
            g = self._group(group)
            e = self._entry(create=False)
            st: _StreamValue = e.value
            g["consumers"].add(consumer)
            out = []
            deleted = []
            next_cursor = "0-0"
            pending_sorted = sorted(g["pending"])
            for i, t in enumerate(pending_sorted):
                if t < lo:
                    continue
                p = g["pending"][t]
                if now_ms - p["time_ms"] < min_idle_ms:
                    continue
                f = st.entries.get(t)
                if f is None:  # deleted entry: drop from PEL (Redis 6.2+)
                    del g["pending"][t]
                    deleted.append(_fmt_id(t))
                    continue
                p.update(consumer=consumer, time_ms=now_ms)
                if not justid:
                    # JUSTID leaves the delivery counter untouched (Redis
                    # contract): an inspection sweep must not push entries
                    # toward dead-letter thresholds keyed on the count.
                    p["count"] += 1
                out.append((_fmt_id(t), self._decode(f)))
                if len(out) >= count:
                    # Truncated: continue from the id AFTER this one.
                    later = [u for u in pending_sorted[i + 1:]
                             if u in g["pending"]]
                    if later:
                        next_cursor = _fmt_id(later[0])
                    break
            if with_cursor:
                return next_cursor, out, deleted
            return out


class ReliableTopic(GridObject):
    """→ org/redisson/RedissonReliableTopic.java: at-least-once topic
    backed by a stream — every listener is a consumer group cursor, so
    subscribers added later replay from their subscription point and slow
    listeners never lose messages (contrast fire-and-forget RTopic)."""

    KIND = "stream"

    def __init__(self, name, client):
        super().__init__(name, client)
        self._stream = Stream(name, client)
        self._listeners: dict[int, tuple[str, Any]] = {}
        self._next_id = 0
        self._pump: Optional[Any] = None

    def publish(self, message: Any) -> int:
        """Appends to the stream; returns subscriber count across EVERY
        handle of this topic (the shared stream's listener groups are the
        truth — this handle's _listeners alone reported 0 when the
        subscribers lived on another handle).  Delivery is signal-driven:
        Stream.add notifies the SHARED store condition, so the pump wakes
        for publishes from ANY handle."""
        self._stream.add({"m": message})
        with self._store.lock:
            e = self._stream._entry(create=False)
            if e is None:
                return 0
            return sum(
                1 for g in e.value.groups if g.startswith("listener:")
            )

    def _added_count(self) -> int:
        e = self._stream._entry(create=False)
        return 0 if e is None else e.value.added

    def add_listener(self, listener) -> int:
        import uuid

        with self._store.lock:
            lid = self._next_id
            self._next_id += 1
            group = f"listener:{uuid.uuid4().hex[:12]}"
            self._stream.create_group(group, from_id="$")
            self._listeners[lid] = (group, listener)
            if self._pump is None:
                t = threading.Thread(
                    target=self._pump_loop, name="rtpu-reliable-topic",
                    daemon=True,
                )
                self._pump = t
                t.start()
        return lid

    def remove_listener(self, listener_id: int) -> None:
        with self._store.cond:
            got = self._listeners.pop(listener_id, None)
            if got is not None:
                try:
                    self._stream.remove_group(got[0])
                except Exception:
                    pass
            if not self._listeners:
                # Last listener gone: the pump loop exits on its next
                # wake (it would otherwise spin for the process lifetime)
                # and a future add_listener starts a fresh one.
                self._store.cond.notify_all()

    def _pump_loop(self) -> None:
        while True:
            with self._store.lock:
                if not self._listeners:
                    # No subscribers: terminate instead of idling forever;
                    # add_listener re-arms a fresh pump.
                    if self._pump is threading.current_thread():
                        self._pump = None
                    return
                subs = list(self._listeners.items())
                seen = self._added_count()
            delivered = False
            for lid, (group, fn) in subs:
                try:
                    msgs = self._stream.read_group(group, "pump", count=64)
                except ValueError:
                    continue  # group removed concurrently
                for mid, fields in msgs:
                    try:
                        fn(self._name, fields["m"])
                    except Exception:  # listener errors must not kill the
                        pass  # pump (at-least-once: message still acked,
                        # matching the reference's listener-isolation)
                    self._stream.ack(group, mid)
                    delivered = True
            if not delivered:
                # Park on the SHARED store condition Stream.add notifies
                # (condvar, not a poll tax); the added-counter re-check
                # under the lock closes the publish-before-park window;
                # 1 s fallback bounds exotic writers that bypass XADD.
                with self._store.cond:
                    if self._added_count() == seen:
                        self._store.cond.wait(timeout=1.0)

    def count_listeners(self) -> int:
        with self._store.lock:
            return len(self._listeners)
