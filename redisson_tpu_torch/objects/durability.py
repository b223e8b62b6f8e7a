"""Sketch-state durability: TTL, DUMP/RESTORE and snapshots.

Counterpart of ``redisson_tpu/objects/durability.py`` (→
org/redisson/RedissonExpirable.java and RedissonObject#dump/restore; the
client-side analog of Redis RDB persistence):

- ``expire``/``remain_ttl_ms``: a named sketch carries an absolute expiry
  deadline; an expired object vanishes from the keyspace (lazy check on
  lookup plus a background sweeper every 0.25 s).
- ``dump``/``restore``: one object's row + params as data-only bytes,
  ``RTPU | u32 header_len | json header | npy row`` (version 2).
- ``snapshot``/``restore_snapshot``: every pool D2H'd into an ``.npz``
  plus a metadata JSON, written to fsynced tmp files, renamed, and the
  directory fsynced; ``Config.snapshot_dir``/``snapshot_interval_s`` arm
  restore-on-create and periodic snapshots.

The pool layout, the dump header and the snapshot metadata are the JAX
package's, key for key, so a dump or snapshot of either package restores
into the other.  While a breaker is open, DUMP and snapshots take a
degraded object's bytes from its host mirror (the device row is stale
then), so they keep every mirror-acked write.  Residency tiers travel
too: a HOST-resident tenant's mirror is captured as a standalone array
(``tier_array``), a DISK-resident one by its blob's file name and CRC
(``residency_blobs`` lists them, and blob GC keeps every file the latest
snapshot names); restore reinstates both tiers.  Delete, rename and
expiry drop tier and near-cache state with the object.  Chaos points:
``snapshot.save`` (dump and snapshot), ``snapshot.load`` (restore and
restore_snapshot) and ``snapshot.rename`` (between the tmp-file fsync and
the renames).

Left out here, with the queue items that bring them: the topology change
and the reshard branch of ``restore_snapshot`` (multi-GPU); the journal
records behind the commit gate (the durability tier).  A snapshot taken
on a mesh is refused rather than misread.

Mixed into TorchSketchEngine (objects/engines.py).
"""

from __future__ import annotations

import io
import json
import logging
import os
import struct
import threading
import time
import zlib
from typing import Optional

import numpy as np

from redisson_tpu_torch import chaos as _chaos
from redisson_tpu_torch.tenancy.registry import TenantEntry, spec_for

_log = logging.getLogger(__name__)

_DUMP_VERSION = 2
_DUMP_MAGIC = b"RTPU"
_SNAP_META = "sketch_meta.json"
_SNAP_POOLS = "sketch_pools.npz"
# The JAX package stamps its m-shard threshold (``mbit_threshold_words``,
# default 1 << 22) into every snapshot; one card has no m-sharding, so
# the port writes the default as a stamp for the JAX reader.
_MBIT_THRESHOLD_STAMP = 1 << 22


def _crc_stream(f, chunk: int = 1 << 22) -> int:
    """CRC32 of an open binary file in bounded chunks (a multi-GB pool
    blob is never read resident just to checksum it)."""
    crc = 0
    while True:
        buf = f.read(chunk)
        if not buf:
            return crc
        crc = zlib.crc32(buf, crc)


def _fsync_dir(directory: str) -> None:
    """fsync the directory entry so renames inside it survive a host
    crash (a file's own fsync does not cover its name)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:  # platform without directory open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _tiered(t: dict) -> bool:
    """A snapshot tenant on the host or disk tier (no device row)."""
    return t.get("residency", "device") != "device" or int(t["row"]) < 0


def safe_load_npy(buf: io.BytesIO) -> np.ndarray:
    """np.load for UNTRUSTED dump payloads: a forged .npy header can
    declare a huge shape, so the declared size is checked against the
    bytes present BEFORE anything is allocated."""
    version = np.lib.format.read_magic(buf)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(buf)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(buf)
    else:
        raise ValueError(f"unsupported npy version {version}")
    if dtype.hasobject:
        raise ValueError("object arrays are not allowed in dumps")
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    nbytes = count * dtype.itemsize
    remaining = len(buf.getbuffer()) - buf.tell()
    if nbytes > remaining:
        raise ValueError(
            f"npy payload declares {nbytes} bytes but only {remaining} follow"
        )
    arr = np.frombuffer(buf.read(nbytes), dtype=dtype, count=count)
    return arr.reshape(shape, order="F" if fortran else "C")


class SketchDurabilityMixin:
    """Requires: self.registry, self.executor, self.topk, self._drain(),
    self.delete(), ``_sweeper``/``_snapshotter`` (None) and
    ``_snapshot_lock`` set by the engine, the degraded-mirror surface
    (self._mirrors, self._mirror_lock, self._host_row), the commit gate
    (self._journal_gate), self.nearcache and self.residency."""

    def _reap_row(self, pool, row: int) -> None:
        """Zero-then-free a detached row, atomic against reallocation
        under the dispatch lock (a row is reusable only once clean).  A
        HOST/DISK-resident entry (row < 0) owns none."""
        if row < 0:
            return
        with self.executor._dispatch_lock:
            # rtpulint: disable=RT001 zero-then-free must be atomic vs reallocation under the dispatch lock (the discipline residency.reclaim cites): releasing between would hand out a dirty row
            self.executor.zero_row(pool, row)
            pool.free_row(row)

    # -- TTL / expiry (RedissonExpirable analog) ---------------------------

    def _expire_if_due(self, entry) -> bool:
        """True if ``entry`` expired (and was reaped) just now.  Reaps by
        entry IDENTITY (detach_if), so a racing reaper never removes a
        fresh object re-created under the same name.  Under the commit
        gate, like delete: a tier transition of the same entry either
        completes first (its row is then quarantined, not reaped here) or
        finds the entry gone."""
        if entry is None or entry.expire_at is None or time.time() < entry.expire_at:
            return False
        with self._journal_gate:
            if self.registry.detach_if(entry.name, entry) is None:
                return True
            self._drain()
            self._reap_row(entry.pool, entry.row)
            # The heavy-hitter table, cached reads (a structural epoch
            # advance), residency state (heat, host bytes, the disk blob)
            # and a mirror die with the object: a successor under this
            # name must not inherit them.
            self.topk.drop(entry.name)
            self.nearcache.drop_object(entry.name)
            self.residency.drop(entry.name)
            if self._mirrors:
                with self._mirror_lock:
                    self._mirrors.pop(entry.name, None)
        return True

    def _live_lookup(self, name: str):
        entry = self.registry.lookup(name)
        if entry is not None and self._expire_if_due(entry):
            return None
        return entry

    def expire(self, name: str, ttl_s: float) -> bool:
        """PEXPIRE analog: delete ``ttl_s`` seconds from now."""
        return self.expire_at(name, time.time() + ttl_s)

    def expire_at(self, name: str, ts: float) -> bool:
        entry = self._live_lookup(name)
        if entry is None:
            return False
        entry.expire_at = float(ts)
        self._ensure_sweeper()
        return True

    def clear_expire(self, name: str) -> bool:
        """PERSIST analog: True if a TTL was removed."""
        entry = self._live_lookup(name)
        if entry is None or entry.expire_at is None:
            return False
        entry.expire_at = None
        return True

    def remain_ttl_ms(self, name: str) -> int:
        """PTTL convention: -2 absent, -1 no TTL, else remaining ms."""
        entry = self._live_lookup(name)
        if entry is None:
            return -2
        if entry.expire_at is None:
            return -1
        return max(0, int((entry.expire_at - time.time()) * 1000))

    def _ensure_sweeper(self) -> None:
        """Background expiry sweep, started on the first TTL; checked
        again under the registry lock so two first TTLs start one."""
        if self._sweeper is not None:
            return
        with self.registry._lock:
            if self._sweeper is not None:
                return
            stop = threading.Event()

            def sweep():
                while not stop.wait(0.25):
                    for entry in self.registry.entries():
                        if entry.expire_at is not None:
                            self._expire_if_due(entry)

            t = threading.Thread(target=sweep, name="rtpu-sketch-sweeper", daemon=True)
            self._sweeper = (t, stop)
            t.start()

    def _stop_sweeper(self) -> None:
        sw = self._sweeper
        if sw is not None:
            sw[1].set()
            sw[0].join(timeout=5.0)
            self._sweeper = None

    # -- DUMP / RESTORE (RedissonObject#dump/restore analog) ---------------

    def dump(self, name: str) -> Optional[bytes]:
        """Serialized object state, or None if absent (upstream raises on
        a missing key at RESTORE, not DUMP).  Data-only wire format:
        ``RTPU | u32 header_len | json header | npy row``."""
        entry = self._live_lookup(name)
        if entry is None:
            return None
        if _chaos.ENABLED:
            _chaos.fire("snapshot.save")
        # A degraded entry's truth is its mirror: dumping the device row
        # would roll back every mirror-acked write on a later RESTORE.
        row = self._host_row(entry)
        header = json.dumps(
            {
                "v": _DUMP_VERSION,
                "kind": entry.kind,
                "class_key": list(entry.pool.spec.class_key),
                "params": dict(entry.params),
                # CMS: the heavy-hitter candidate table travels with the
                # counters, or a restored top_k() would come back empty.
                "topk": self.topk.export_state(name),
            }
        ).encode("utf-8")
        buf = io.BytesIO()
        np.save(buf, row, allow_pickle=False)
        return _DUMP_MAGIC + struct.pack("<I", len(header)) + header + buf.getvalue()

    def restore(self, name: str, data: bytes, replace: bool = False) -> None:
        """Recreate an object from ``dump`` bytes.  BUSYKEY analog: raises
        if the name exists and ``replace`` is False."""
        with self._journal_gate:
            self._restore_impl(name, data, replace)

    def _restore_impl(self, name: str, data: bytes, replace: bool) -> None:
        if _chaos.ENABLED:
            _chaos.fire("snapshot.load", data=data)
        if len(data) < 8 or data[:4] != _DUMP_MAGIC:
            raise ValueError("not a sketch dump (bad magic)")
        (hlen,) = struct.unpack("<I", data[4:8])
        d = json.loads(data[8 : 8 + hlen].decode("utf-8"))
        row = safe_load_npy(io.BytesIO(data[8 + hlen :]))
        if d.get("v") != _DUMP_VERSION:
            raise ValueError(f"unsupported dump version: {d.get('v')}")
        # Validate the untrusted candidate table and the row's geometry
        # BEFORE any mutation: a malformed blob must not leave a
        # half-restored object behind.
        topk_decoded = type(self.topk).decode_state(d.get("topk"), name)
        class_key = tuple(d.get("class_key", ()))
        units = spec_for(d["kind"], class_key).row_units
        if row.shape != (units,):
            raise ValueError(f"dump row has shape {row.shape}, pool expects ({units},)")
        if self._live_lookup(name) is not None:
            if not replace:
                raise ValueError(f"BUSYKEY: {name!r} already exists")
            self.delete(name)
        self._guard_foreign(name)  # one keyspace: RESTORE can't shadow grid
        entry, created = self.registry.try_create(name, d["kind"], class_key, d["params"])
        if not created:  # raced a concurrent creator
            raise ValueError(f"BUSYKEY: {name!r} already exists")
        if entry.row < 0:
            # Born cold (created past the device budget): the restored
            # state lives in a HOST mirror until heat promotes it.
            self._install_residency_mirror(entry, row=row)
        else:
            self.executor.write_row(entry.pool, entry.row, row)
        # Unconditional: also clears a ghost table when the dump has none.
        self.topk.import_decoded(topk_decoded, name)
        # RESTORE replaces readable state wholesale: retire every cached
        # read of this name (structural epoch advance).
        self.nearcache.drop_object(name)

    # -- Snapshots (client-side RDB analog) --------------------------------

    def snapshot(self, directory: str) -> None:
        """Atomic full-state snapshot: every pool D2H plus the registry
        metadata, in fsynced tmp files renamed into place (directory
        fsynced), so neither a concurrent restore nor a host crash sees a
        torn snapshot.  One snapshot at a time (the periodic snapshotter,
        explicit calls and shutdown share the tmp names)."""
        if _chaos.ENABLED:
            _chaos.fire("snapshot.save")
        os.makedirs(directory, exist_ok=True)
        with self._snapshot_lock:
            # The gate holds writers and tier transitions off across
            # drain → capture, so the capture is one point in time.
            with self._journal_gate:
                # rtpulint: disable=RT001 the drain barrier MUST run inside the snapshot lock: it is what makes the capture consistent, and the only waiters on this lock are other whole-snapshot callers (periodic/explicit/shutdown), never the write path
                self._drain()
                meta, arrays = self._snapshot_capture()
            self._snapshot_write(directory, meta, arrays)
            self._last_save_ts = time.time()  # LASTSAVE
            # Blob GC barrier: the latest durable snapshot now names
            # exactly these blob files; retired blobs outside the set may
            # be deleted.
            self.residency.note_snapshot_refs(meta["residency_blobs"])
            # Companion-state hook (the client wires the grid keyspace
            # here): runs outside the engine locks, inside the snapshot
            # lock, so periodic, explicit and shutdown snapshots persist
            # the whole logical keyspace, not just the sketch pools.
            if self.snapshot_extra is not None:
                self.snapshot_extra(directory)

    def _snapshot_capture(self):
        """Point-in-time (meta, arrays) under the engine locks, in the
        mirror -> registry -> dispatch order that reconcile (mirror ->
        write_row) and try_create -> alloc_row use (the JAX package
        deadlocked a periodic snapshot against object creation when the
        order was inverted): no create, delete, growth, launch or mirror
        op interleaves with the D2H reads.  No file I/O here."""
        with self._mirror_lock, self.registry._lock, self.executor._dispatch_lock:
            arrays, pool_meta = {}, []
            pools = self.registry.pools()
            for i, pool in enumerate(pools):
                arrays[f"pool_{i}"] = self.executor.state_to_host(pool)
                pool_meta.append({
                    "key": list(pool.spec.key),
                    "kind": pool.spec.kind,
                    "class_key": list(pool.spec.class_key),
                    "capacity": pool.capacity,
                })
            if self._mirrors:
                # Degraded overlay: a mirrored entry's truth lives on the
                # host — patch its row into the captured array so a
                # snapshot taken mid-degradation keeps mirror-acked writes.
                pool_idx = {id(p): i for i, p in enumerate(pools)}
                for e in self.registry.entries():
                    mirror = self._mirrors.get(e.name)
                    if mirror is None or e.row < 0:
                        continue
                    u = e.pool.row_units
                    arr = arrays[f"pool_{pool_idx[id(e.pool)]}"]
                    arr[e.row * u : (e.row + 1) * u] = mirror.encode(u)
            # Residency tiers: a HOST-resident tenant's truth is its
            # mirror — captured as a standalone array; a DISK-resident
            # tenant's truth is its blob — captured by exact file name and
            # CRC (blobs are versioned, and GC never deletes a file the
            # latest snapshot names).  A born-cold tenant with neither has
            # all-zero state and restores as a first-touch zero mirror.
            disk_index = self.residency.disk_index()
            blob_refs = []
            tenants = []
            for j, e in enumerate(self.registry.entries()):
                t = {
                    "name": e.name,
                    "kind": e.kind,
                    "pool_key": list(e.pool.spec.key),
                    "row": e.row,
                    "params": e.params,
                    "expire_at": e.expire_at,
                    "replica_rows": e.replica_rows,
                    "residency": e.residency,
                }
                if e.row < 0:
                    mirror = self._mirrors.get(e.name)
                    info = disk_index.get(e.name)
                    if mirror is not None:
                        key = f"tier_{j}"
                        arrays[key] = np.asarray(mirror.encode(e.pool.row_units))
                        t["residency"] = "host"
                        t["tier_array"] = key
                    elif info is not None:
                        t["residency"] = "disk"
                        t["blob"] = info["file"]
                        t["blob_crc"] = int(info["crc"])
                        t["blob_nbytes"] = int(info["nbytes"])
                        blob_refs.append(info["file"])
                    else:
                        t["residency"] = "host"  # born cold: zeros
                tenants.append(t)
            meta = {
                "residency_blobs": blob_refs,
                "version": _DUMP_VERSION,
                "pools": pool_meta,
                "tenants": tenants,
                # Without the candidate tables a restore keeps every CMS
                # counter but forgets which keys were heavy.
                "topk": self.topk.export_state(),
                "num_shards": 1,
                "mbit_threshold_words": _MBIT_THRESHOLD_STAMP,
                "journal_seq": 0,
            }
        return meta, arrays

    def _snapshot_write(self, directory: str, meta: dict, arrays) -> None:
        """Crash-safe install: tmp files fsynced before the renames and
        the directory after.  The metadata carries the pool blob's CRC,
        so a crash between the two renames (new pools under old metadata)
        is detected at restore instead of installing mismatched tables."""
        tmp_npz = os.path.join(directory, _SNAP_POOLS + ".tmp.npz")
        tmp_meta = os.path.join(directory, _SNAP_META + ".tmp")
        np.savez(tmp_npz, **arrays)
        with open(tmp_npz, "rb") as f:
            crc = _crc_stream(f)
            os.fsync(f.fileno())
        meta = dict(meta, pools_crc=crc)
        with open(tmp_meta, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if _chaos.ENABLED:
            # The crash window between write and rename: a fault here
            # must leave the previous snapshot intact and loadable.
            _chaos.fire("snapshot.rename")
        os.replace(tmp_npz, os.path.join(directory, _SNAP_POOLS))
        os.replace(tmp_meta, os.path.join(directory, _SNAP_META))
        _fsync_dir(directory)

    def restore_snapshot(self, directory: str) -> bool:
        """Load a snapshot written by ``snapshot`` (by either package);
        True if one was found.  The keyspace must be empty.  Everything
        is validated before the first mutation, so a refused snapshot
        leaves the engine as it was."""
        meta_path = os.path.join(directory, _SNAP_META)
        pools_path = os.path.join(directory, _SNAP_POOLS)
        if not (os.path.exists(meta_path) and os.path.exists(pools_path)):
            return False
        if _chaos.ENABLED:
            _chaos.fire("snapshot.load")
        with open(meta_path) as f:
            meta = json.load(f)
        if "pools_crc" in meta:
            with open(pools_path, "rb") as f:
                if _crc_stream(f) != int(meta["pools_crc"]):
                    raise ValueError(
                        "torn snapshot: pool blob CRC does not match its "
                        "metadata (crash between renames?); refusing to restore"
                    )
        if int(meta.get("num_shards", 1)) != 1:
            raise ValueError(
                f"snapshot was taken on {meta['num_shards']} shards; this "
                f"engine restores single-device snapshots only"
            )
        topk_decoded = type(self.topk).decode_state(meta.get("topk"))
        with np.load(pools_path) as data, \
                self.registry._lock, self.executor._dispatch_lock:
            if self.registry.entries():
                live = self.registry.names()
                raise ValueError(
                    f"BUSYKEY: {live[:3]!r} already exist; snapshot restore "
                    f"needs an empty keyspace"
                )
            arrays, capacity = [], {}
            for i, pm in enumerate(meta["pools"]):
                arr = data[f"pool_{i}"]
                spec = spec_for(pm["kind"], tuple(pm["class_key"]))
                cap = int(pm["capacity"])
                if arr.shape != (cap * spec.row_units + 1,):
                    raise ValueError(
                        f"snapshot pool {pm['key']} holds {arr.shape} elements; "
                        f"{cap} rows need {cap * spec.row_units + 1}"
                    )
                arrays.append(arr)
                capacity[spec.key] = cap
            # HOST/DISK tenants own no row (and need no pool of their own
            # in the snapshot: a tenant born cold into a fresh size class
            # has none).
            tiered = [t for t in meta["tenants"] if _tiered(t)]
            for t in tiered:
                if t.get("residency") == "disk":
                    # A missing blob would silently lose the object:
                    # refuse before the first mutation.
                    blob_dir = self.residency.directory
                    if not t.get("blob") or not blob_dir or not os.path.exists(
                            os.path.join(blob_dir, t["blob"])):
                        raise ValueError(
                            f"residency blob {t.get('blob')!r} for {t['name']!r} "
                            f"is missing (residency_dir={blob_dir!r})")
                if t.get("tier_array") and t["tier_array"] not in data.files:
                    raise ValueError(f"snapshot tenant {t['name']!r} lacks its tier array")
            placed = [(tuple(t["pool_key"]), int(t["row"]))
                      for t in meta["tenants"] if not _tiered(t)]
            if len(set(placed)) != len(placed) or not all(
                0 <= row < capacity.get(key, 0) for key, row in placed
            ):
                raise ValueError("snapshot places tenants outside its pools or twice")
            for i, pm in enumerate(meta["pools"]):
                pool = self.registry.pool_for(pm["kind"], tuple(pm["class_key"]))
                # The snapshot's capacity is installed verbatim: re-rounding
                # could clamp a grown pool and hand out occupied rows.
                pool.capacity = int(pm["capacity"])
                pool._free = list(range(pool.capacity - 1, -1, -1))
                pool.generation += 1
                self.executor.state_from_host(pool, arrays[i])
            by_key = {tuple(p.spec.key): p for p in self.registry.pools()}
            pending_mirrors = []  # (entry, row array): HOST tenants
            pending_disk = []  # (name, file, crc, nbytes): DISK tenants
            for t in meta["tenants"]:
                if _tiered(t):
                    # HOST/DISK tenant: no device row; its tier installs
                    # after the registry/dispatch locks are released (the
                    # mirror lock orders before them engine-wide).
                    pool = by_key.get(tuple(t["pool_key"]))
                    if pool is None:
                        pool = self.registry.pool_for(t["kind"], tuple(t["pool_key"])[1:])
                    tier = t.get("residency", "host")
                    entry = TenantEntry(
                        t["name"], t["kind"], pool, -1, dict(t["params"]),
                        t.get("expire_at"), residency=tier,
                    )
                    self.registry._tenants[t["name"]] = entry
                    if tier == "disk":
                        pending_disk.append((
                            t["name"], t["blob"], int(t.get("blob_crc", 0)),
                            int(t.get("blob_nbytes", 0)),
                        ))
                    elif t.get("tier_array"):
                        pending_mirrors.append((entry, np.asarray(data[t["tier_array"]])))
                    # else: born cold — zeros on first touch.
                else:
                    pool = by_key[tuple(t["pool_key"])]
                    row = int(t["row"])
                    pool._free.remove(row)
                    self.registry._tenants[t["name"]] = TenantEntry(
                        t["name"], t["kind"], pool, row, dict(t["params"]),
                        t.get("expire_at"),
                    )
                if t.get("expire_at") is not None:
                    self._ensure_sweeper()
        for entry, rowdata in pending_mirrors:
            self._install_residency_mirror(entry, row=rowdata)
        for name, fname, crc, nbytes in pending_disk:
            self.residency.adopt_blob(name, fname, crc, nbytes)
        self.topk.import_decoded(topk_decoded)
        # Whole-keyspace event: every cached read predates the restored
        # state.
        self.nearcache.invalidate_all()
        return True

    def _start_snapshotter(self, directory: str, interval_s: float) -> None:
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.snapshot(directory)
                except Exception:  # best-effort persistence, never silent
                    _log.exception("periodic snapshot to %s failed", directory)

        t = threading.Thread(target=loop, name="rtpu-snapshotter", daemon=True)
        self._snapshotter = (t, stop)
        t.start()

    def _stop_snapshotter(self) -> None:
        sn = self._snapshotter
        if sn is not None:
            sn[1].set()
            # A snapshot may be mid-write: the final one must come after it.
            sn[0].join(timeout=30.0)
            self._snapshotter = None
