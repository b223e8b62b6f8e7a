"""Heat-based residency ladder (counterpart of
``redisson_tpu/storage/residency.py``).

Device rows become a CACHE over host golden mirrors over per-object
disk blobs: every sketch is in exactly one of three residency states —

- ``DEVICE`` — a size-class pool row; the fast tier, bounded by the
  ``residency_device_rows`` budget.
- ``HOST``   — a golden-model mirror (objects/degraded.py codecs, the
  exact bidirectional conversion the breaker failover already uses;
  promotion writes the mirror's encoding into the pool tensor with one
  H2D copy, demotion reads the row with one D2H).
  Demoted is NOT degraded: no breaker, no flags — reads and writes
  serve from the mirror at host speed through the same
  ``_serve_degraded`` boundary every engine method already crosses.
- ``DISK``   — a CRC-framed per-object blob (the engine's data-only
  dump format inside the snapshot tier's frame discipline: tmp file →
  fsync → rename, so a kill -9 mid-spill never publishes a torn blob).

Transition protocol (why no schedule loses an acked write or serves a
stale read):

- Every transition holds the engine's JOURNAL GATE.  All mutating
  engine methods hold the gate across their entire
  check-residency → submit window, so no write can be in flight
  between "the op decided device" and "the row moved".
- Demotion drains the coalescer before reading the row (queued ops
  land first), installs the mirror under the mirror lock (serving
  atomically switches to the mirror), and bumps ``_mirror_epoch`` so a
  concurrent breaker seeder discards its possibly-stale row snapshot.
- The freed device row is QUARANTINED, not recycled: readers do not
  hold the gate, so a read that captured the row before the mirror
  install may still flush against it — the row keeps its (bit-
  identical) pre-demotion contents until a later cycle has drained the
  coalescer again, only then is it zeroed and returned to the pool.
- Promotion allocates through the size-class pools
  (``SizeClassPool.alloc_row``), writes the mirror's encoding, repoints
  ``entry.row`` BEFORE dropping the mirror (a reader racing the drop
  falls through ``_mirror_call``'s None to a fully-written row), and
  bumps ``_mirror_epoch``.
- Spill serializes the mirror while holding the gate (writers
  excluded; degraded-path reads never mutate mirror state), publishes
  the blob durably, and only then drops the mirror.

Snapshot interplay: blobs are versioned ``obj-<h>-<seq>.rts`` files; a
snapshot records the exact filename + CRC per DISK tenant, and a blob
is garbage-collected only when the LATEST durable snapshot no longer
references it — so a restore from that snapshot never finds a blob that
was overwritten with post-snapshot state.  Blob files and their framing
are the JAX package's, byte for byte: a blob spilled by either package
loads in the other.

Failures are typed and never served: a blob that fails its magic or CRC
check raises ValueError, the chaos points ``storage.spill`` and
``storage.load`` raise at their boundary, and a promotion whose H2D
write fails frees its row and raises ``ResidencyError``.  The
background thread counts what it could not do in ``errors``.

Born-cold creation: when the device budget is full, ``try_create``
skips the row alloc entirely (``TenantRegistry.alloc_gate``) and the
first access installs a zero-seeded mirror — the fast tier holds the
working set, not the keyspace, so pool arrays never grow past the
budget just because the tenant COUNT did.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import struct
import threading
import time
import zlib
from collections import deque
from typing import Optional

import numpy as np

from redisson_tpu_torch.analysis import witness as _witness
from redisson_tpu_torch import chaos as _chaos
from redisson_tpu_torch.executor.failures import RedissonTpuError

_log = logging.getLogger(__name__)

DEVICE = "device"
HOST = "host"
DISK = "disk"

# Sentinel for "no device row" (HOST/DISK residency).  Everything that
# enumerates an entry's rows must treat row < 0 as "none".
ROW_NONE = -1

# Transition latencies kept per kind for percentiles (the newest ones).
_LATENCY_SAMPLES = 1 << 16


class ResidencyError(RedissonTpuError):
    """A tier transition failed part-way and was rolled back (the entry
    keeps its tier); raised, never turned into served state."""

_BLOB_MAGIC = b"RTPB"
_BLOB_HDR = struct.Struct("<II")  # payload_len, crc32


def _frame_blob(payload: bytes) -> bytes:
    return _BLOB_MAGIC + _BLOB_HDR.pack(
        len(payload), zlib.crc32(payload)
    ) + payload


def _unframe_blob(data: bytes) -> bytes:
    """CRC-checked payload, or ValueError (a torn/corrupt blob must
    refuse loudly, never install garbage state)."""
    if len(data) < 12 or data[:4] != _BLOB_MAGIC:
        raise ValueError("not a residency blob (bad magic)")
    plen, crc = _BLOB_HDR.unpack(data[4:12])
    payload = data[12:12 + plen]
    if len(payload) != plen or zlib.crc32(payload) != crc:
        raise ValueError("residency blob failed its CRC check")
    return payload


def _parse_dump_row(payload: bytes) -> np.ndarray:
    """The device-row array out of an engine dump blob (the spill
    payload IS the dump format — kind/params ride in the header for
    debuggability, but load only needs the row: the live registry
    entry is authoritative for everything else)."""
    import io
    import struct as _struct

    from redisson_tpu_torch.objects.durability import _DUMP_MAGIC, safe_load_npy

    if len(payload) < 8 or payload[:4] != _DUMP_MAGIC:
        raise ValueError("residency blob payload is not a sketch dump")
    (hlen,) = _struct.unpack("<I", payload[4:8])
    return np.asarray(safe_load_npy(io.BytesIO(payload[8 + hlen:])))


class ResidencyManager:
    """One per TorchSketchEngine.  Owns the heat tracker, the background
    demotion/promotion thread, the disk-blob index, and the quarantine
    of freed device rows."""

    def __init__(self, engine, cfg, *, obs=None, clock=time.monotonic):
        from redisson_tpu_torch.storage.heat import HeatTracker

        self._eng = engine
        self.obs = obs
        self._clock = clock
        self.device_rows = int(getattr(cfg, "residency_device_rows", 0))
        self.max_host_bytes = int(
            getattr(cfg, "residency_max_host_bytes", 0)
        )
        self.max_disk_bytes = int(
            getattr(cfg, "residency_max_disk_bytes", 0)
        )
        self.promote_heat = float(
            getattr(cfg, "residency_promote_heat", 4.0)
        )
        self.interval_s = (
            float(getattr(cfg, "residency_interval_ms", 200)) / 1000.0
        )
        self.directory = getattr(cfg, "residency_dir", None)
        self.heat = HeatTracker(
            half_life_s=float(
                getattr(cfg, "residency_heat_half_life_s", 10.0)
            ),
            clock=clock,
        )
        self._lock = _witness.named(threading.Lock(), "storage.residency")
        self._host_nbytes: dict[str, int] = {}   # HOST mirrors, by name
        self._disk: dict[str, dict] = {}         # name -> {file, crc, nbytes}
        self._snapshot_refs: set[str] = set()    # blob files the latest snapshot names
        self._gc: set[str] = set()               # retired blob files awaiting GC
        self._quarantine: list[tuple] = []       # (pool, row)
        self._spill_seq = 0
        # Lifetime transition counters (INFO memory tier breakdown).
        self.promotions = 0
        self.demotions = 0
        self.spills = 0
        self.loads = 0
        self.host_serves = 0  # ops served from HOST mirrors (not degraded)
        self.errors = 0  # background maintenance cycles that raised
        self._latency_ms = {
            k: deque(maxlen=_LATENCY_SAMPLES)
            for k in ("promote", "demote", "spill", "load")
        }
        self._thread: Optional[tuple] = None

    # -- heat feed (the engine's entry-point lookups) ----------------------

    def touch(self, name: str, n: int = 1) -> None:
        self.heat.touch(name, n)

    # -- tier accounting ---------------------------------------------------

    def host_objects(self) -> int:
        return len(self._host_nbytes)

    def host_bytes(self) -> int:
        with self._lock:
            return sum(self._host_nbytes.values())

    def disk_objects(self) -> int:
        return len(self._disk)

    def disk_bytes(self) -> int:
        with self._lock:
            return sum(d["nbytes"] for d in self._disk.values())

    def device_rows_used(self) -> int:
        return sum(
            p.used_rows() for p in self._eng.registry.pools()
        )

    def device_full(self) -> bool:
        """The registry's alloc gate: True ⇒ try_create births the
        tenant HOST-resident instead of growing a pool past the
        budget."""
        b = self.device_rows
        return b > 0 and self.device_rows_used() >= b

    def stats(self) -> dict:
        return {
            "device_rows_budget": self.device_rows,
            "device_rows_used": self.device_rows_used(),
            "host_objects": self.host_objects(),
            "host_bytes": self.host_bytes(),
            "disk_objects": self.disk_objects(),
            "disk_bytes": self.disk_bytes(),
            "promotions": self.promotions,
            "demotions": self.demotions,
            "spills": self.spills,
            "loads": self.loads,
            "host_serves": self.host_serves,
            "quarantined_rows": len(self._quarantine),
            "errors": self.errors,
        }

    def latency_ms(self, percentiles=(50, 99)) -> dict:
        """{kind: {"n", "p<q>" ...}} over the newest transition times (ms),
        for the kinds that ran at least once."""
        out = {}
        for kind, samples in self._latency_ms.items():
            xs = np.asarray(list(samples), np.float64)
            if xs.size:
                out[kind] = {"n": int(xs.size), **{
                    f"p{q}": float(np.percentile(xs, q)) for q in percentiles}}
        return out

    # -- observability helpers ---------------------------------------------

    def _note(self, kind: str, name: str, t0: float) -> None:
        """Counter, flight-recorder event and LATENCY sample for one
        transition (the per-kind latency deque feeds ``stats``)."""
        self._latency_ms[kind].append((self._clock() - t0) * 1e3)
        obs = self.obs
        if obs is None:
            return
        fam = {
            "promote": getattr(obs, "residency_promotions", None),
            "demote": getattr(obs, "residency_demotions", None),
            "spill": getattr(obs, "residency_spills", None),
            "load": getattr(obs, "residency_loads", None),
        }.get(kind)
        if fam is not None:
            fam.inc()
        events = getattr(obs, "events", None)
        if events is not None:
            # Tier transitions only (promote / demote / spill); disk loads
            # are read-path volume, not a control-plane decision.  One
            # literal per branch: every emitted kind is a registered
            # literal.
            ms = round((self._clock() - t0) * 1e3, 3)
            if kind == "promote":
                events.emit("residency.promote", object=name, ms=ms)
            elif kind == "demote":
                events.emit("residency.demote", object=name, ms=ms)
            elif kind == "spill":
                events.emit("residency.spill", object=name, ms=ms)
        lat = getattr(obs, "latency", None)
        if lat is not None and lat.threshold_ms > 0:
            lat.record(
                f"residency-{kind}", (self._clock() - t0) * 1e3
            )

    def _span(self, kind: str, name: str):
        """Per-transition span in the tracing plane: a
        ``residency:<kind>`` scope while tracing is on, a nullcontext on
        the off path."""
        from redisson_tpu_torch.obs import trace as _trace

        obs = self.obs
        if obs is None or not _trace.ENABLED:
            return contextlib.nullcontext()
        # rtpulint: disable=RT011 the scope is handed off: _Annotated delegates __enter__/__exit__ to it verbatim, so the span always reaches end/abandon through the with-statement below
        scope = obs.trace.span_scope(f"residency:{kind}")

        class _Annotated:
            def __enter__(_s):
                sp = scope.__enter__()
                if sp is not None:
                    sp.annotate("object", name)
                return sp

            def __exit__(_s, *exc):
                return scope.__exit__(*exc)

        return _Annotated()

    # -- transitions -------------------------------------------------------

    def demote(self, name: str) -> bool:
        """DEVICE → HOST: the entry's row contents move into an exact
        golden mirror; the row is quarantined for deferred reclaim.
        See the module doc for the full write/read race argument."""
        from redisson_tpu_torch.objects.degraded import mirror_for_entry

        eng = self._eng
        t0 = self._clock()
        with self._span("demote", name), eng._journal_gate:
            entry = eng._live_lookup(name)
            if entry is None or entry.row < 0 or entry.replica_rows:
                return False
            if eng.health.degraded_kind(entry.kind):
                # A breaker owns this kind's mirror lifecycle right now
                # (and the device read below would be failing anyway).
                return False
            if entry.name in eng._mirrors:
                return False
            # Queued coalesced ops (every writer held the gate at
            # submit, so all accepted writes are either applied or
            # queued) land on the row before the capture read.
            eng._drain()
            try:
                row = np.array(
                    eng.executor.read_row(entry.pool, entry.row)
                )
            except Exception:
                return False
            mirror = mirror_for_entry(entry, row)
            mirror.residency = HOST
            with eng._mirror_lock:
                if entry.name in eng._mirrors:
                    return False  # breaker seeder won the install race
                if eng.health.degraded_kind(entry.kind):
                    return False
                eng._mirrors[entry.name] = mirror
                # Device row about to be retired under any in-flight
                # breaker seeder: its row snapshot is stale.
                eng._mirror_epoch += 1
                pool, old_row = entry.pool, entry.row
                entry.row = ROW_NONE
                entry.residency = HOST
            with self._lock:
                self._quarantine.append((pool, old_row))
                self._host_nbytes[name] = int(row.nbytes)
            self.demotions += 1
        self._note("demote", name, t0)
        return True

    def promote(self, name: str) -> bool:
        """HOST (or DISK, via an implicit load) → DEVICE: one H2D write of
        the mirror's encoding into a fresh pool row.  A failed write frees
        the row and raises ResidencyError; the entry stays HOST."""
        eng = self._eng
        t0 = self._clock()
        with self._span("promote", name), eng._journal_gate:
            entry = eng._live_lookup(name)
            if entry is None or entry.row >= 0:
                return False
            if eng.health.degraded_kind(entry.kind):
                return False  # device failing: stay host-resident
            if entry.residency == DISK and not self._load_gated(entry):
                return False
            with eng._mirror_lock:
                mirror = eng._mirrors.get(name)
                if mirror is None or getattr(
                    mirror, "residency", None
                ) != HOST:
                    return False
                row = entry.pool.alloc_row()
                try:
                    # rtpulint: disable=RT001 the write-back MUST hold the mirror lock: a mirror op interleaving between encode and the mirror drop would apply to a mirror about to be discarded (lost acked write) — the reconcile write-back discipline
                    eng.executor.write_row(
                        entry.pool, row,
                        np.asarray(mirror.encode(entry.pool.row_units)),
                    )
                except Exception as exc:
                    try:
                        # rtpulint: disable=RT001 same atomic window as the write above
                        eng.executor.zero_row(entry.pool, row)
                        entry.pool.free_row(row)
                    except Exception:  # device failing
                        # Leak one row rather than recycle it dirty.
                        _log.exception("zeroing row %d after a failed promotion", row)
                    raise ResidencyError(
                        f"promotion of {name!r} failed writing its row: {exc!r}"
                    ) from exc
                # Row first, THEN drop the mirror: a reader racing the
                # drop falls through _mirror_call's None onto a row
                # that is already fully written.
                entry.row = row
                entry.residency = DEVICE
                del eng._mirrors[name]
                eng._mirror_epoch += 1
            with self._lock:
                self._host_nbytes.pop(name, None)
            self.promotions += 1
        self._note("promote", name, t0)
        return True

    def spill(self, name: str) -> bool:
        """HOST → DISK: the mirror serializes into a CRC-framed blob
        (durable before the mirror drops) and the host bytes free."""
        eng = self._eng
        if not self.directory:
            return False
        t0 = self._clock()
        with self._span("spill", name), eng._journal_gate:
            entry = eng._live_lookup(name)
            if entry is None or entry.row >= 0:
                return False
            with eng._mirror_lock:
                mirror = eng._mirrors.get(name)
                if mirror is None or getattr(
                    mirror, "residency", None
                ) != HOST:
                    return False
            # Queued coalesced chunks that serve from this mirror at
            # FLUSH time (the bitset mixed path) land before the
            # capture; new writers are excluded by the gate (we hold
            # it) — after the drain the dump below is a stable capture.
            # (Gate-free READ chunks can still enqueue post-drain; the
            # flush path reloads the mirror for those stragglers.)
            eng._drain()
            payload = eng.dump(name)
            if payload is None:
                return False
            framed = _frame_blob(payload)
            if self.max_disk_bytes > 0 and (
                self.disk_bytes() + len(framed) > self.max_disk_bytes
            ):
                return False  # disk cap: entry stays HOST
            if _chaos.ENABLED:
                _chaos.fire("storage.spill")
            fname = self._write_blob(name, framed)
            with eng._mirror_lock:
                # The gate made the mirror stable; drop it and flip the
                # tier only after the blob is durable on disk.
                eng._mirrors.pop(name, None)
                entry.residency = DISK
            with self._lock:
                self._host_nbytes.pop(name, None)
                old = self._disk.get(name)
                if old is not None:
                    self._retire_blob_locked(old["file"])
                self._disk[name] = {
                    "file": fname,
                    "crc": zlib.crc32(payload),
                    "nbytes": len(framed),
                }
            self.spills += 1
        self._note("spill", name, t0)
        return True

    def load(self, name: str) -> bool:
        """DISK → HOST (also the born-cold first touch): rebuild the
        mirror from the blob (CRC-checked) or, for a tenant created
        past the device budget, from zeros."""
        eng = self._eng
        t0 = self._clock()
        with self._span("load", name), eng._journal_gate:
            entry = eng._live_lookup(name)
            if entry is None or entry.row >= 0:
                return False
            ok = self._load_gated(entry)
        if ok:
            self._note("load", name, t0)
        return ok

    def load_nowait(self, entry) -> bool:
        """Gate-NON-BLOCKING mirror load for the coalescer FLUSH path:
        a transition holding the gate may be draining — i.e. waiting
        on the very flush that is asking — so blocking here would be
        an AB-BA (flush→gate vs gate→drain).  False when the gate is
        contended; the caller retries or fails the chunk typed."""
        eng = self._eng
        if not eng._journal_gate.acquire(blocking=False):
            return False
        try:
            return self._load_gated(entry)
        finally:
            eng._journal_gate.release()

    def install_host(self, entry, row=None, mirror=None) -> None:
        """Install ``entry`` as HOST-resident from a row array or a
        ready-made mirror — the snapshot-restore / journal-writeback
        install path (engine init, or under the journal gate).  The
        manager owns the mirror install AND the host-bytes accounting,
        so the two can never drift (the SpanRecorder.reset lesson)."""
        from redisson_tpu_torch.objects.degraded import mirror_for_entry

        eng = self._eng
        if mirror is None:
            mirror = mirror_for_entry(entry, np.asarray(row))
        mirror.residency = HOST
        with eng._mirror_lock:
            eng._mirrors[entry.name] = mirror
            entry.row = ROW_NONE
            entry.residency = HOST
        with self._lock:
            self._host_nbytes[entry.name] = int(
                entry.pool.row_units
                * np.dtype(entry.pool.spec.dtype).itemsize
            )

    def _load_gated(self, entry) -> bool:
        """Install ``entry``'s HOST mirror from its blob (or zeros for
        a born-cold tenant).  Caller holds the journal gate."""
        from redisson_tpu_torch.objects.degraded import mirror_for_entry

        eng = self._eng
        name = entry.name
        with eng._mirror_lock:
            if name in eng._mirrors:
                entry.residency = HOST
                return True  # raced another loader
        with self._lock:
            info = dict(self._disk.get(name) or {})
        if info:
            if _chaos.ENABLED:
                _chaos.fire("storage.load")
            path = os.path.join(self.directory, info["file"])
            with open(path, "rb") as f:
                payload = _unframe_blob(f.read())
            row = _parse_dump_row(payload)
        else:
            # Born cold (created while the device budget was full):
            # fresh state is all-zeros in every kind's row layout.
            row = np.zeros(
                entry.pool.row_units, entry.pool.spec.dtype
            )
        if row.shape[0] < entry.pool.row_units:
            # The entry migrated to a larger size class while spilled
            # (bitset grow repoints the pool without a row) — pad; the
            # golden models treat trailing zeros as absent bits.
            padded = np.zeros(
                entry.pool.row_units, entry.pool.spec.dtype
            )
            padded[: row.shape[0]] = row
            row = padded
        mirror = mirror_for_entry(entry, row)
        mirror.residency = HOST
        with eng._mirror_lock:
            if name in eng._mirrors:
                entry.residency = HOST
                return True
            eng._mirrors[name] = mirror
            entry.residency = HOST
        with self._lock:
            self._host_nbytes[name] = int(row.nbytes)
            if info:
                # The mirror will accumulate writes: the blob is stale
                # the moment serving resumes.  Retire it (GC keeps any
                # file the latest snapshot still references).
                self._disk.pop(name, None)
                self._retire_blob_locked(info["file"])
        if info:
            self.loads += 1
        return True

    # -- blob files --------------------------------------------------------

    def _write_blob(self, name: str, framed: bytes) -> str:
        from redisson_tpu_torch.objects.durability import _fsync_dir

        os.makedirs(self.directory, exist_ok=True)
        with self._lock:
            self._spill_seq += 1
            seq = self._spill_seq
        h = hashlib.sha1(name.encode("utf-8", "replace")).hexdigest()[:16]
        fname = f"obj-{h}-{seq}.rts"
        tmp = os.path.join(self.directory, fname + ".tmp")
        with open(tmp, "wb") as f:
            f.write(framed)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.directory, fname))
        _fsync_dir(self.directory)
        return fname

    def _retire_blob_locked(self, fname: str) -> None:
        self._gc.add(fname)

    def note_snapshot_refs(self, refs) -> None:
        """The latest durable snapshot references exactly these blob
        files — everything retired and unreferenced may now delete."""
        with self._lock:
            self._snapshot_refs = set(refs)

    def gc_blobs(self) -> int:
        """Delete retired blobs the latest snapshot no longer names."""
        with self._lock:
            dead = [f for f in self._gc if f not in self._snapshot_refs]
            for f in dead:
                self._gc.discard(f)
        n = 0
        for f in dead:
            try:
                os.unlink(os.path.join(self.directory, f))
                n += 1
            except OSError:  # pragma: no cover — already gone
                pass
        return n

    def adopt_blob(self, name: str, fname: str, crc: int,
                   nbytes: int) -> None:
        """Snapshot-restore installs a DISK tenant: the blob must
        exist — a missing file would silently lose the object."""
        path = os.path.join(self.directory or "", fname)
        if not self.directory or not os.path.exists(path):
            raise ValueError(
                f"residency blob {fname!r} for {name!r} is missing "
                f"(residency_dir={self.directory!r})"
            )
        with self._lock:
            self._disk[name] = {
                "file": fname, "crc": int(crc), "nbytes": int(nbytes),
            }
            self._snapshot_refs.add(fname)

    def disk_index(self) -> dict:
        with self._lock:
            return {n: dict(d) for n, d in self._disk.items()}

    # -- lifecycle hooks (delete / rename / expiry) ------------------------

    def drop(self, name: str) -> None:
        self.heat.drop(name)
        with self._lock:
            self._host_nbytes.pop(name, None)
            info = self._disk.pop(name, None)
            if info is not None:
                self._retire_blob_locked(info["file"])

    def rename(self, old: str, new: str) -> None:
        self.heat.rename(old, new)
        with self._lock:
            if old in self._host_nbytes:
                self._host_nbytes[new] = self._host_nbytes.pop(old)
            dest = self._disk.pop(new, None)
            if dest is not None:
                self._retire_blob_locked(dest["file"])
            src = self._disk.pop(old, None)
            if src is not None:
                self._disk[new] = src

    # -- quarantine reclaim ------------------------------------------------

    def reclaim(self) -> int:
        """Zero + free quarantined rows from EARLIER cycles.  A drain
        first: any read that captured a quarantined row pre-demotion
        has flushed against its (intact) contents by the time the row
        recycles — the no-stale-reads half of the protocol."""
        with self._lock:
            pending, self._quarantine = self._quarantine, []
        if not pending:
            return 0
        eng = self._eng
        eng._drain()
        n = 0
        for pool, row in pending:
            with pool._dispatch_lock:
                try:
                    # rtpulint: disable=RT001 zero-then-free must be atomic vs reallocation (the _reap_rows discipline): releasing between would hand out a dirty row
                    eng.executor.zero_row(pool, row)
                except Exception:
                    # Leak one row rather than recycle it dirty.
                    _log.exception("zeroing quarantined row %d", row)
                    continue
                pool.free_row(row)
                n += 1
        return n

    # -- the background residency thread -----------------------------------

    def maintain(self) -> dict:
        """One maintenance cycle: reclaim, enforce the device-rows
        budget (demote coldest), promote the hot set (admission-aware),
        enforce the host-bytes cap (spill coldest), GC blobs.  Returns
        a {action: count} summary (tests drive this synchronously)."""
        out = {"reclaimed": self.reclaim(), "demoted": 0,
               "promoted": 0, "spilled": 0}
        eng = self._eng
        budget = self.device_rows
        if budget <= 0 and self.max_host_bytes <= 0:
            return out
        heat = self.heat.snapshot()
        entries = eng.registry.entries()

        def _heat(e):
            return heat.get(e.name, 0.0)

        if budget > 0:
            device_e = sorted(
                (e for e in entries if e.row >= 0 and not e.replica_rows),
                key=_heat,
            )
            used = self.device_rows_used()
            # 1. budget enforcement: coldest rows demote first.
            while used > budget and device_e:
                e = device_e.pop(0)
                if self.demote(e.name):
                    out["demoted"] += 1
                    used -= 1
            # 2. promotion, admission-aware: no promotion storm may
            #    push queue pressure past the watermark.
            if not self._admission_blocked():
                # One set of hot names, probed per entry: a population
                # 100x the budget is scanned with a set lookup, not a heat
                # lookup and comparison per entry.
                hot = {n for n, h in heat.items() if h >= self.promote_heat}
                if self.promote_heat <= 0:  # untracked names have heat 0
                    hot = None
                cands = sorted(
                    (
                        e for e in entries
                        if e.row < 0 and (hot is None or e.name in hot)
                    ),
                    key=_heat, reverse=True,
                )
                for cand in cands:
                    if self._admission_blocked():
                        break
                    if used < budget:
                        if self.promote(cand.name):
                            out["promoted"] += 1
                            used += 1
                        continue
                    # Budget full: swap in only against a clearly
                    # colder victim (2x hysteresis — no thrash at the
                    # boundary).
                    victim = device_e[0] if device_e else None
                    if victim is None or _heat(victim) * 2.0 >= _heat(cand):
                        break
                    if self.demote(victim.name):
                        device_e.pop(0)
                        out["demoted"] += 1
                        used -= 1
                        if self.promote(cand.name):
                            out["promoted"] += 1
                            used += 1
        if self.max_host_bytes > 0 and self.directory:
            # 3. host-bytes cap: coldest HOST mirrors spill to disk.  Only
            #    entries holding a mirror can spill (a born-cold tenant
            #    never touched has none), and the excess is tracked here
            #    rather than re-summed per spill: with a population 100x
            #    the budget, both keep a cycle linear in the mirrors.
            host_e = sorted(
                (e for e in entries
                 if e.residency == HOST and e.row < 0 and e.name in eng._mirrors),
                key=_heat,
            )
            excess = self.host_bytes() - self.max_host_bytes
            for e in host_e:
                if excess <= 0:
                    break
                nbytes = self._host_nbytes.get(e.name, 0)
                if self.spill(e.name):
                    out["spilled"] += 1
                    excess -= nbytes
        self.gc_blobs()
        return out

    def _admission_blocked(self) -> bool:
        """True while coalescer queue pressure sits past the admission
        watermark — promotions (which cost device writes) wait."""
        eng = self._eng
        c = getattr(eng, "coalescer", None)
        if c is None:
            return False
        pressure = getattr(c, "pressure", None)
        if pressure is None:
            return False
        wm = float(
            getattr(eng.config.gpu_sketch, "admission_watermark", 0.9)
        )
        return pressure() >= wm

    def start(self) -> None:
        """Arm the background thread (idempotent; started lazily when
        a budget first becomes non-zero — CONFIG SET included)."""
        if self._thread is not None:
            return
        stop = threading.Event()

        def loop():
            while not stop.wait(self.interval_s):
                try:
                    self.maintain()
                except Exception:  # counted and logged; the next cycle retries
                    self.errors += 1
                    _log.exception("residency maintenance cycle failed")

        t = threading.Thread(
            target=loop, name="rtpu-residency", daemon=True
        )
        self._thread = (t, stop)
        t.start()

    def shutdown(self) -> None:
        th = self._thread
        if th is not None:
            th[1].set()
            th[0].join(timeout=30.0)
            self._thread = None

    def set_budget(self, device_rows: Optional[int] = None,
                   max_host_bytes: Optional[int] = None,
                   max_disk_bytes: Optional[int] = None,
                   promote_heat: Optional[float] = None) -> None:
        """Live budget changes; arming a budget starts the thread."""
        if device_rows is not None:
            self.device_rows = int(device_rows)
        if max_host_bytes is not None:
            self.max_host_bytes = int(max_host_bytes)
        if max_disk_bytes is not None:
            self.max_disk_bytes = int(max_disk_bytes)
        if promote_heat is not None:
            self.promote_heat = float(promote_heat)
        if self.device_rows > 0 or self.max_host_bytes > 0:
            self.start()
